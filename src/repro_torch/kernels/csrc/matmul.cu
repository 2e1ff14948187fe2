// K1: blocked matrix product C = A @ B on the CUDA cores.
//
// Replaces the reference package's MXU-tiled Pallas kernel
// (src/repro/kernels/matmul/matmul.py, matmul_pallas): the same function --
// (M,K) x (K,N), fp32 accumulation, the result written once in the output
// type -- thought through again for Hopper rather than carried over block by
// block.  The TPU kernel's plan tiles (bm/bn/bk) are a VMEM decision and set
// nothing here.
//
// What bounds it: at every product the linalg path launches, 2*M*N*K
// operations on M*K + K*N + M*N elements sit far above the card's balance
// of operations to bytes, so the bound is IEEE fp32 FFMA at 67 TFLOP/s (no
// TF32: the dispatch gates need relative error < 1e-4; wgmma has no IEEE
// fp32 type).  At 16384^3 the bytes are 0.5 % of the bound.  The trailing
// updates of the blocked trsm and Cholesky have K = 256: there C's write
// (4 bytes an element after 512 operations) is 16 % of the bound, and each
// 128x128 tile of C goes out after only 256 k-steps.
//
// Inside an SM the limit is the operand traffic from shared memory to the
// registers, not the FFMA pipes: the earlier body's 8x8 thread tile (two
// float4 reads of A and two of B per 64 FFMAs) ran at 59 % of the bound
// (PERF.md), and so did an 8x8 tile fed by cp.async.  What the fp32 body
// (matmul_f32_kernel) does about it:
//  - Each thread keeps an 8x16 tile of C in registers: per k, 128 FFMAs on
//    two float4 reads of B's row and half a float4 read of A (four k at a
//    time): 6 shared loads per 128 FFMAs.  A CTA of 128 threads owns a
//    128x128 tile of C, a warp 64x64; 255 registers, no spills.
//  - Two CTAs an SM (__launch_bounds__(128, 2), 103 KB of shared memory
//    each), so one CTA's prologue and epilogue overlap the other's
//    products: at K = 256 a CTA is 8 stages long.
//  - A ring of 3 stages of BK = 32 in dynamic shared memory, one barrier a
//    stage.  Where A's and B's rows are 16-byte aligned, one thread fills a
//    stage with two TMA boxes that complete on the stage's mbarrier: no
//    copy instruction in the other threads (16-byte cp.async copies by
//    every thread measured slower on the card).  A's box arrives in the
//    128-byte swizzle, so a warp's float4 reads over k from 8 consecutive
//    rows hit 8 distinct bank groups; B's rows are read as consecutive
//    granules.  TMA zero-fills the ragged edges.
//  - Elsewhere (rows not 16-byte aligned, as at 130 columns) each thread
//    copies its granules by 4-byte cp.async, masked and zero-filled only
//    where a stage crosses an edge, A's rows padded to BK + 4 floats for
//    the same conflict-free reads.
//  - The epilogue writes float4s where C's rows are 16-byte aligned and
//    masked scalars on the ragged edge.
//  - Tiles run in groups of 16 tile rows, column by column inside a group,
//    so the CTAs resident at one time share strips of A and B in L2.  The
//    batch (the stacked ranks of a process grid) runs on blockIdx.z, with
//    64-bit offsets.
// Each element of C sums its products in ascending k, one FFMA each.
//
// bf16 inputs keep the earlier body (matmul_kernel: 128x128 tiles,
// BK = 8, staged through registers, widened on load); no path launches it.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstdint>

#include "kernels.h"

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int THREADS = 256;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename TI, typename TO>
__global__ void __launch_bounds__(THREADS)
    matmul_kernel(const TI* __restrict__ A, const TI* __restrict__ B,
                  TO* __restrict__ C, int M, int N, int K, long long sa,
                  long long lda, long long sb, long long ldb, long long sc,
                  long long ldc) {
  __shared__ __align__(16) float As[2][BK][BM];
  __shared__ __align__(16) float Bs[2][BK][BN];

  const long long z = blockIdx.z;
  A += z * sa;
  B += z * sb;
  C += z * sc;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;

  // global -> shared: each thread moves 4 elements of the A slice (one row,
  // 4 consecutive k) and 4 of the B slice (one k, 4 consecutive columns)
  const int a_row = tid >> 1;
  const int a_col = (tid & 1) * 4;
  const int b_row = tid >> 5;
  const int b_col = (tid & 31) * 4;
  // register tile: rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, same for cols
  const int tx = tid & 15;
  const int ty = tid >> 4;

  float ra[4];
  float rb[4];
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  auto load = [&](int k0) {
    const int gr = m0 + a_row;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gc = k0 + a_col + i;
      ra[i] = (gr < M && gc < K) ? widen(A[gr * lda + gc]) : 0.f;
    }
    const int gk = k0 + b_row;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = n0 + b_col + j;
      rb[j] = (gk < K && gc < N) ? widen(B[gk * ldb + gc]) : 0.f;
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) As[buf][a_col + i][a_row] = ra[i];
    *reinterpret_cast<float4*>(&Bs[buf][b_row][b_col]) =
        make_float4(rb[0], rb[1], rb[2], rb[3]);
  };

  const int steps = (K + BK - 1) / BK;
  load(0);
  stage(0);
  __syncthreads();
  for (int t = 0; t < steps; ++t) {
    const int buf = t & 1;
    if (t + 1 < steps) load((t + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // the other buffer was last read before the previous barrier
    if (t + 1 < steps) stage(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (col < N) put(&C[row * ldc + col], acc[i][j]);
    }
  }
}

template <typename TI, typename TO>
void launch(const void* a, const void* b, void* c, int batch, int m, int n,
            int k, long long sa, long long lda, long long sb, long long ldb,
            long long sc, long long ldc, cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, batch);
  matmul_kernel<TI, TO><<<grid, THREADS, 0, stream>>>(
      static_cast<const TI*>(a), static_cast<const TI*>(b),
      static_cast<TO*>(c), m, n, k, sa, lda, sb, ldb, sc, ldc);
}

// ---- the fp32 body -------------------------------------------------------

namespace f32 {

constexpr int BM = 128;                  // a CTA's tile of C: BM x BN
constexpr int BN = 128;
constexpr int BK = 32;                   // k-steps a stage
constexpr int STAGES = 3;                // the ring
constexpr int TN = 16;                   // a thread's tile: 8 rows x TN
constexpr int THREADS = BM * BN / (8 * TN);
constexpr int WARP_N = 4 * TN;           // a warp's tile: 64 x WARP_N
constexpr int WARPS_N = BN / WARP_N;
constexpr int GROUP = 16;                // tile rows of a group of tiles
constexpr int AS = BK + 4;               // row stride of A's padded tile
constexpr int A_BYTES = BM * AS * 4;     // A's tile (padded or swizzled)
constexpr int STAGE_BYTES = A_BYTES + BK * BN * 4;
// the ring, its mbarriers, and slack to align the base to 1024 bytes
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 8 * STAGES + 1024;
constexpr uint32_t TMA_BYTES = (BM * BK + BK * BN) * 4;  // a stage's boxes
constexpr int A_ROW = BK / 4;            // 16-byte granules of A's rows
constexpr int A_STEP = THREADS / A_ROW;  // cp.async: rows between copies
constexpr int B_STEP = THREADS / 32;
constexpr int A_COPIES = BM / A_STEP;    // granules a thread a stage
constexpr int B_COPIES = BK / B_STEP;
constexpr int MAX_DEVICES = 64;

static_assert(STAGE_BYTES % 1024 == 0 && A_BYTES % 1024 == 0,
              "the tiles of a stage stay 1024-byte aligned");
static_assert(BK * 4 == 128, "A's rows are one 128-byte swizzle span");

__device__ __forceinline__ int words_from(int end, int at) {
  return max(0, min(4, end - at));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copies words (0..4) of src into the 16-byte granule at shared address dst
// by 4-byte cp.async, and zero-fills the rest; src is not read for the
// words that are zero-filled (and is then any valid address).
__device__ __forceinline__ void copy_granule(uint32_t dst, const float* src,
                                             int words) {
#pragma unroll
  for (int e = 0; e < 4; ++e)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     dst + 4 * e),
                 "l"(e < words ? src + e : src), "r"(e < words ? 4 : 0));
}

// The same for a granule that lies wholly inside the operand.
__device__ __forceinline__ void copy_granule(uint32_t dst, const float* src) {
#pragma unroll
  for (int e = 0; e < 4; ++e)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst +
                                                                     4 * e),
                 "l"(src + e));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 3-D map at (c0, c1, c2) into shared memory, completing on
// the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime so that
// the extension need not link libcuda; null if the driver lacks it.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

__device__ __forceinline__ float part(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Writes v[0 .. min(4, avail)) to c[0 ..]: one float4 when vec_c and the
// whole granule lies inside C, else masked scalars.
template <typename TO>
__device__ __forceinline__ void store_granule(TO* c, const float* v,
                                              int avail, bool vec_c) {
  if constexpr (sizeof(TO) == 4) {
    if (vec_c && avail >= 4) {
      *reinterpret_cast<float4*>(c) = make_float4(v[0], v[1], v[2], v[3]);
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e < avail) put(c + e, v[e]);
}

// C[z] = A[z] B[z] for fp32 A and B.  With TMA, a stage arrives as two
// boxes of the maps ta (K, M, batch) and tb (N, K, batch) at batch
// coordinate z, or 0 for a shared operand (stride 0); A's box in the
// 128-byte swizzle.  Otherwise each thread copies its granules of A and B
// by 4-byte cp.async from the pointers, A's rows padded to AS floats.
// vec_c when C's rows are 16-byte aligned (float4 stores).
template <bool TMA, typename TO>
__global__ void __launch_bounds__(THREADS, 2)
    matmul_f32_kernel(const __grid_constant__ CUtensorMap ta,
                      const __grid_constant__ CUtensorMap tb,
                      const float* __restrict__ A, const float* __restrict__ B,
                      TO* __restrict__ C, int M, int N, int K, long long sa,
                      long long lda, long long sb, long long ldb,
                      long long sc, long long ldc, bool vec_c) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t smem = (raw + 1023) & ~1023u;
  const unsigned char* smem_ptr = smem_raw + (smem - raw);
  const uint32_t bars = smem + STAGES * STAGE_BYTES;
  const int z = blockIdx.z;
  A += z * sa;
  B += z * sb;
  C += z * sc;

  // grouped tile order: GROUP tile rows, column by column
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles_m = (M + BM - 1) / BM;
  const int per_group = GROUP * tiles_n;
  const int first = blockIdx.x / per_group * GROUP;
  const int rows = min(tiles_m - first, GROUP);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first + in_group % rows) * BM;
  const int n0 = in_group / rows * BN;
  const int steps = max(1, (K + BK - 1) / BK);  // K = 0: one stage of zeros
  const int tid = threadIdx.x;

  // cp.async copy roles, fixed: A rows ar + A_STEP q at granule ag, B rows
  // br + B_STEP q at granule bg
  const int ar = tid / A_ROW, ag = tid % A_ROW;
  const int br = tid >> 5, bg = tid & 31;
  const uint32_t a_dst = smem + (ar * AS + 4 * ag) * 4;
  const uint32_t b_dst = smem + A_BYTES + (br * BN + 4 * bg) * 4;
  const int b_words = words_from(N, n0 + 4 * bg);
  // a tile wholly inside A's rows and B's columns copies its interior
  // stages without masks
  const bool interior = m0 + BM <= M && n0 + BN <= N;
  const float* a_src = A + (m0 + ar) * lda + 4 * ag;
  const float* b_src = B + br * ldb + n0 + 4 * bg;
  const int za = sa ? z : 0, zb = sb ? z : 0;

  auto load = [&](int t) {
    const int k0 = t * BK;
    const uint32_t off = (t % STAGES) * STAGE_BYTES;
    if (TMA) {
      const uint32_t bar = bars + 8 * (t % STAGES);
      mbar_expect_tx(bar, TMA_BYTES);
      tma_load(smem + off, &ta, bar, k0, m0, za);
      tma_load(smem + off + A_BYTES, &tb, bar, n0, k0, zb);
      return;
    }
    if (interior && k0 + BK <= K) {
#pragma unroll
      for (int q = 0; q < A_COPIES; ++q)
        copy_granule(a_dst + off + A_STEP * q * AS * 4,
                     a_src + A_STEP * q * lda + k0);
#pragma unroll
      for (int q = 0; q < B_COPIES; ++q)
        copy_granule(b_dst + off + B_STEP * q * BN * 4,
                     b_src + (k0 + B_STEP * q) * ldb);
      return;
    }
    const int kw = words_from(K, k0 + 4 * ag);
#pragma unroll
    for (int q = 0; q < A_COPIES; ++q) {
      const int r = m0 + ar + A_STEP * q;
      const int w = r < M ? kw : 0;
      copy_granule(a_dst + off + A_STEP * q * AS * 4,
                   w ? A + r * lda + k0 + 4 * ag : A, w);
    }
#pragma unroll
    for (int q = 0; q < B_COPIES; ++q) {
      const int k = k0 + br + B_STEP * q;
      const int w = k < K ? b_words : 0;
      copy_granule(b_dst + off + B_STEP * q * BN * 4,
                   w ? B + k * ldb + n0 + 4 * bg : B, w);
    }
  };

  // register tile: rows row0 + 8 i, columns col0 + 16 h + {0..3}; a warp
  // owns 64 rows x WARP_N columns
  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = (warp / WARPS_N) * 64 + (lane >> 2);
  const int col0 = (warp % WARPS_N) * WARP_N + (lane & 3) * 4;
  // A's granule (k 4 g .. 4 g + 3) of row r: in the 128-byte swizzle at
  // granule g ^ (r & 7), and (row0 + 8 i) & 7 is the same for every i
  const int swz = row0 & 7;
  auto a_at = [&](const float* as, int i, int g) {
    return TMA ? as + (row0 + 8 * i) * BK + ((g ^ swz) << 2)
               : as + (row0 + 8 * i) * AS + 4 * g;
  };
  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  if (TMA && tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (TMA) __syncthreads();

  // the ring: stages 0 .. STAGES - 2 in flight before the first product;
  // each later stage is issued once the stage it replaces was consumed
  // (cp.async: one group committed for every stage, empty past the last,
  // so the counts stay uniform)
  if (!TMA || tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < steps) load(s);
      if (!TMA) commit();
    }
  }
  for (int t = 0; t < steps; ++t) {
    if (TMA) {
      __syncthreads();  // stage t - 1 was consumed
      if (tid == 0 && t + STAGES - 1 < steps) load(t + STAGES - 1);
      mbar_wait(bars + 8 * (t % STAGES), (t / STAGES) & 1);
    } else {
      wait_groups<STAGES - 2>();  // this thread's copies of stage t landed
      __syncthreads();            // everyone's; stage t - 1 was consumed
      if (t + STAGES - 1 < steps) load(t + STAGES - 1);
      commit();
    }
    const float* as = reinterpret_cast<const float*>(
        smem_ptr + (t % STAGES) * STAGE_BYTES);
    const float* bs = as + A_BYTES / 4;
#pragma unroll
    for (int g = 0; g < BK / 4; ++g) {
      float4 a[8];  // A[rows, 4 g .. 4 g + 3]
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(a_at(as, i, g));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float b[TN];  // B[4 g + kk, columns]
#pragma unroll
        for (int h = 0; h < TN / 4; ++h) {
          const float4 v = *reinterpret_cast<const float4*>(
              bs + (4 * g + kk) * BN + col0 + 16 * h);
          b[4 * h] = v.x;
          b[4 * h + 1] = v.y;
          b[4 * h + 2] = v.z;
          b[4 * h + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float ai = part(a[i], kk);
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ai, b[j], acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + row0 + 8 * i;
    if (row >= M) continue;
    TO* c = C + row * ldc + n0 + col0;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h)
      store_granule(c + 16 * h, acc[i] + 4 * h, N - (n0 + col0 + 16 * h),
                    vec_c);
  }
}

// Raises the kernel's shared-memory limit above the 48 KB default and asks
// for the largest carveout (two CTAs an SM), once per device: the calls
// cost host time on every launch otherwise.
template <bool TMA, typename TO>
cudaError_t allow_smem() {
  static std::atomic<bool> done[MAX_DEVICES];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < MAX_DEVICES && done[device].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(matmul_f32_kernel<TMA, TO>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(matmul_f32_kernel<TMA, TO>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && device < MAX_DEVICES) done[device].store(true);
  return err;
}

// The TMA map of one fp32 operand of (cols, rows, batch) elements with row
// and batch strides in elements (a batch stride of 0: one matrix for the
// whole batch), boxes of (box_cols, box_rows, 1), zeros outside.  The
// caller has checked that the operand is 16-byte aligned with strides in
// multiples of 4 elements.
bool tensor_map(CUtensorMap* map, const float* ptr, int cols, int rows,
                int batch, long long ld, long long stride, int box_cols,
                int box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  // the stride of an axis of extent 1 is never read: the extent below it
  const long long row = rows > 1 ? ld : (cols + 3LL) / 4 * 4;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(stride ? batch : 1)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(row) * 4,
      static_cast<cuuint64_t>(stride && batch > 1 ? stride : rows * row) * 4};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<float*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool TMA, typename TO>
cudaError_t launch(const CUtensorMap& ta, const CUtensorMap& tb,
                   const float* a, const float* b, TO* c, int batch, int m,
                   int n, int k, long long sa, long long lda, long long sb,
                   long long ldb, long long sc, long long ldc,
                   cudaStream_t stream) {
  const cudaError_t err = allow_smem<TMA, TO>();
  if (err != cudaSuccess) return err;
  const int tiles = ((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  const bool vec_c = (reinterpret_cast<uintptr_t>(c) & 15) == 0 &&
                     ((sc | ldc) & 3) == 0;
  matmul_f32_kernel<TMA, TO><<<dim3(tiles, 1, batch), THREADS, SMEM_BYTES,
                               stream>>>(ta, tb, a, b, c, m, n, k, sa, lda,
                                         sb, ldb, sc, ldc, vec_c);
  return cudaSuccess;
}

// TMA when every row (and batch) start of A and B is 16-byte aligned and
// the maps encode; 4-byte cp.async otherwise.
template <typename TO>
cudaError_t launch_f32(const void* a, const void* b, void* c, int batch,
                       int m, int n, int k, long long sa, long long lda,
                       long long sb, long long ldb, long long sc,
                       long long ldc, cudaStream_t stream) {
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  TO* tc = static_cast<TO*>(c);
  CUtensorMap ta{}, tb{};
  const bool aligned =
      k > 0 &&
      ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
       15) == 0 &&
      ((sa | lda | sb | ldb) & 3) == 0;
  if (aligned &&
      tensor_map(&ta, fa, k, m, batch, lda, sa, BK, BM,
                 CU_TENSOR_MAP_SWIZZLE_128B) &&
      tensor_map(&tb, fb, n, k, batch, ldb, sb, BN, BK,
                 CU_TENSOR_MAP_SWIZZLE_NONE))
    return launch<true>(ta, tb, fa, fb, tc, batch, m, n, k, sa, lda, sb, ldb,
                        sc, ldc, stream);
  return launch<false>(ta, tb, fa, fb, tc, batch, m, n, k, sa, lda, sb, ldb,
                       sc, ldc, stream);
}

}  // namespace f32

}  // namespace

extern "C" cudaError_t repro_matmul(const void* a, const void* b, void* c,
                                    int in_type, int out_type, int batch,
                                    int m, int n, int k, long long sa,
                                    long long lda, long long sb,
                                    long long ldb, long long sc,
                                    long long ldc, cudaStream_t stream) {
  const bool known = (in_type == REPRO_F32 || in_type == REPRO_BF16) &&
                     (out_type == REPRO_F32 || out_type == REPRO_BF16);
  // the grid: batch on z (at most 65535), the fp32 body's tiles on x
  const long long tiles = static_cast<long long>((m + f32::BM - 1) / f32::BM) *
                          ((n + f32::BN - 1) / f32::BN);
  if (!known || batch < 1 || batch > 65535 || m < 1 || n < 1 || k < 0 ||
      tiles > INT_MAX)
    return cudaErrorInvalidValue;
  if (in_type == REPRO_F32 && out_type == REPRO_F32)
    return f32::launch_f32<float>(a, b, c, batch, m, n, k, sa, lda, sb, ldb,
                                  sc, ldc, stream);
  if (in_type == REPRO_F32)
    return f32::launch_f32<__nv_bfloat16>(a, b, c, batch, m, n, k, sa, lda,
                                          sb, ldb, sc, ldc, stream);
  if (out_type == REPRO_F32)
    launch<__nv_bfloat16, float>(a, b, c, batch, m, n, k, sa, lda, sb, ldb,
                                 sc, ldc, stream);
  else
    launch<__nv_bfloat16, __nv_bfloat16>(a, b, c, batch, m, n, k, sa, lda,
                                         sb, ldb, sc, ldc, stream);
  return cudaSuccess;
}

extern "C" cudaError_t repro_matmul_info(long long* out) {
  const auto kernel = f32::matmul_f32_kernel<true, float>;
  cudaError_t err = f32::allow_smem<true, float>();
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, kernel, f32::THREADS, f32::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<long long>(attr.localSizeBytes);
  out[2] = static_cast<long long>(attr.sharedSizeBytes);
  out[3] = f32::SMEM_BYTES;
  out[4] = ctas;
  return cudaSuccess;
}
