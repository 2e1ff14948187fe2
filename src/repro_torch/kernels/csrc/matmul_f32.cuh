// K1's fp32 body (matmul_f32_kernel) and its launchers, templated on the
// CTA tile (Tile below), and what K1's translation units share (Call, the
// launchers' declarations).  matmul.cu says what the body does and why; this
// header holds it so that each compiled tile is its own translation unit
// (matmul_tile_<BM>x<BN>.cu), which the build compiles in parallel, and
// matmul.cu's entry points reach a tile through run_at / info_at, and the
// bf16 body (matmul_bf16.cu) through run_bf16.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstdint>

#include "hopper.cuh"
#include "kernels.h"

namespace repro_k1 {

// One call of the fp32 body, as repro_matmul received it.
struct Call {
  const void* a;
  const void* b;
  void* c;
  int out_type, batch, m, n, k;
  long long sa, lda, sb, ldb, sc, ldc;
  cudaStream_t stream;
};

// The compiled CTA tiles (BM x BN), a tag each; kernels/matmul/ops.py's
// CTA_TILES lists the same and cta_tile maps a plan onto one.
template <int BM_, int BN_>
struct Cta {
  static constexpr int BM = BM_;
  static constexpr int BN = BN_;
};

// Calls f with the tag of CTA tile (bm, bn); an uncompiled tile gives
// cudaErrorInvalidValue and calls nothing.
template <typename F>
cudaError_t with_tile(int bm, int bn, F&& f) {
  if (bm == 128 && bn == 128) return f(Cta<128, 128>{});
  if (bm == 64 && bn == 64) return f(Cta<64, 64>{});
  if (bm == 64 && bn == 128) return f(Cta<64, 128>{});
  if (bm == 128 && bn == 64) return f(Cta<128, 64>{});
  if (bm == 256 && bn == 64) return f(Cta<256, 64>{});
  if (bm == 256 && bn == 128) return f(Cta<256, 128>{});
  return cudaErrorInvalidValue;
}

// A tile's launch (repro_matmul's contract for fp32 inputs) and its
// attributes (repro_matmul_info's), each defined in the tile's own
// translation unit.
template <int BM, int BN>
cudaError_t run_at(const Call& call);
template <int BM, int BN>
cudaError_t info_at(long long* out);

// A call of the bf16 body on the tensor cores (matmul_bf16.cu), whatever
// the tile: launches it and returns cudaSuccess (or the error of raising its
// shared-memory limit), or launches nothing and returns
// cudaErrorMisalignedAddress where TMA cannot load A or B (rows or batch
// starts not 16-byte aligned, K = 0, maps that do not encode), and
// cudaErrorInvalidValue for more than INT_MAX tiles.
cudaError_t run_bf16(const Call& call);

namespace {

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

namespace f32 {

using namespace repro_hopper;

constexpr int BK = 32;                   // k-steps a stage
constexpr int GROUP = 16;                // tile rows of a group of tiles
constexpr int AS = BK + 4;               // row stride of A's padded tile
constexpr int A_ROW = BK / 4;            // 16-byte granules of A's rows
constexpr int MAX_DEVICES = 64;

static_assert(BK * 4 == 128, "A's rows are one 128-byte swizzle span");

// One compiled configuration of the body: a CTA's tile of C (BM x BN), a
// thread's tile (8 rows x TN columns; a warp's 64 x 4 TN), the ring's
// depth and the CTAs an SM that __launch_bounds__ asks for.
template <int BM_, int BN_, int TN_, int STAGES_, int CTAS_>
struct Tile {
  static constexpr int BM = BM_;
  static constexpr int BN = BN_;
  static constexpr int TN = TN_;
  static constexpr int STAGES = STAGES_;
  static constexpr int CTAS = CTAS_;
  static constexpr int THREADS = BM * BN / (8 * TN);
  static constexpr int WARP_N = 4 * TN;
  static constexpr int WARPS_N = BN / WARP_N;
  static constexpr int A_BYTES = BM * AS * 4;   // A's tile (padded or swizzled)
  static constexpr int STAGE_BYTES = A_BYTES + BK * BN * 4;
  // the ring, its mbarriers, and slack to align the base to 1024 bytes
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 8 * STAGES + 1024;
  static constexpr uint32_t TMA_BYTES = (BM * BK + BK * BN) * 4;
  static constexpr int A_STEP = THREADS / A_ROW;  // cp.async: rows between
  static constexpr int B_ROW = BN / 4;            // copies; B's granules
  static constexpr int B_STEP = THREADS / B_ROW;
  static constexpr int A_COPIES = BM / A_STEP;    // granules a thread a stage
  static constexpr int B_COPIES = BK / B_STEP;

  static_assert(BM % 64 == 0 && BN % WARP_N == 0 && TN % 4 == 0,
                "whole warps of 64 x 4 TN");
  static_assert(BM <= 256 && BN <= 256, "a TMA box edge is at most 256");
  static_assert(THREADS % A_ROW == 0 && BM % A_STEP == 0,
                "every thread copies whole rows' granules of A");
  static_assert(THREADS % B_ROW == 0 && BK % B_STEP == 0,
                "every thread copies whole rows' granules of B");
  static_assert(STAGE_BYTES % 1024 == 0 && A_BYTES % 1024 == 0,
                "the tiles of a stage stay 1024-byte aligned");
  static_assert(SMEM_BYTES <= 232448, "a CTA takes at most 227 KB");
  static_assert(CTAS * (SMEM_BYTES + 1024) <= 233472,
                "CTAS rings fit an SM's 228 KB of shared memory");
  static_assert(THREADS * CTAS <= 2048, "an SM holds 2048 threads");
};

// The compiled configurations, by CTA tile (with_tile above lists the
// same), each compiled in matmul_tile_<BM>x<BN>.cu.
// 128 x 128 is the default: the tile of every path that passes no plan or
// the heuristic one.  Each keeps 8 warps an SM: a thread's tile is 8 x 16
// (about 255 registers) where its CTAs then hold 8 warps, 8 x 8 otherwise;
// the ring has 4 stages where they fit beside the CTAs an SM, else 3.
using Tile64x64 = Tile<64, 64, 8, 3, 4>;      //  64 threads, 52 KB
using Tile64x128 = Tile<64, 128, 8, 4, 2>;    // 128 threads, 101 KB
using Tile128x64 = Tile<128, 64, 8, 4, 2>;    // 128 threads, 105 KB
using Tile128x128 = Tile<128, 128, 16, 3, 2>; // 128 threads, 103 KB
using Tile256x64 = Tile<256, 64, 8, 4, 1>;    // 256 threads, 177 KB
using Tile256x128 = Tile<256, 128, 16, 4, 1>; // 256 threads, 209 KB

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
// vec_c when C's rows are 16-byte aligned (float4 stores).  T is the
// configuration (Tile): its CTA tile, thread tile, ring and occupancy.
template <class T, bool TMA, typename TO>
__global__ void __launch_bounds__(T::THREADS, T::CTAS)
    matmul_f32_kernel(const __grid_constant__ CUtensorMap ta,
                      const __grid_constant__ CUtensorMap tb,
                      const float* __restrict__ A, const float* __restrict__ B,
                      TO* __restrict__ C, int M, int N, int K, long long sa,
                      long long lda, long long sb, long long ldb,
                      long long sc, long long ldc, bool vec_c) {
  constexpr int BM = T::BM, BN = T::BN, TN = T::TN, STAGES = T::STAGES;
  constexpr int WARPS_N = T::WARPS_N, WARP_N = T::WARP_N;
  constexpr int A_BYTES = T::A_BYTES, STAGE_BYTES = T::STAGE_BYTES;
  constexpr int A_STEP = T::A_STEP, B_STEP = T::B_STEP;
  constexpr int A_COPIES = T::A_COPIES, B_COPIES = T::B_COPIES;
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
  const int br = tid / T::B_ROW, bg = tid % T::B_ROW;
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
      mbar_expect_tx(bar, T::TMA_BYTES);
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
template <class T, bool TMA, typename TO>
cudaError_t allow_smem() {
  static std::atomic<bool> done[MAX_DEVICES];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < MAX_DEVICES && done[device].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(matmul_f32_kernel<T, TMA, TO>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(matmul_f32_kernel<T, TMA, TO>,
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

template <class T, bool TMA, typename TO>
cudaError_t launch(const CUtensorMap& ta, const CUtensorMap& tb,
                   const float* a, const float* b, TO* c, int batch, int m,
                   int n, int k, long long sa, long long lda, long long sb,
                   long long ldb, long long sc, long long ldc,
                   cudaStream_t stream) {
  const cudaError_t err = allow_smem<T, TMA, TO>();
  if (err != cudaSuccess) return err;
  const int tiles = ((m + T::BM - 1) / T::BM) * ((n + T::BN - 1) / T::BN);
  const bool vec_c = (reinterpret_cast<uintptr_t>(c) & 15) == 0 &&
                     ((sc | ldc) & 3) == 0;
  matmul_f32_kernel<T, TMA, TO>
      <<<dim3(tiles, 1, batch), T::THREADS, T::SMEM_BYTES, stream>>>(
          ta, tb, a, b, c, m, n, k, sa, lda, sb, ldb, sc, ldc, vec_c);
  return cudaSuccess;
}

// TMA when every row (and batch) start of A and B is 16-byte aligned and
// the maps encode; 4-byte cp.async otherwise.  T is the configuration.
template <class T, typename TO>
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
      tensor_map(&ta, fa, k, m, batch, lda, sa, BK, T::BM,
                 CU_TENSOR_MAP_SWIZZLE_128B) &&
      tensor_map(&tb, fb, n, k, batch, ldb, sb, T::BN, BK,
                 CU_TENSOR_MAP_SWIZZLE_NONE))
    return launch<T, true>(ta, tb, fa, fb, tc, batch, m, n, k, sa, lda, sb,
                           ldb, sc, ldc, stream);
  return launch<T, false>(ta, tb, fa, fb, tc, batch, m, n, k, sa, lda, sb,
                          ldb, sc, ldc, stream);
}


// A call at configuration T: the grid check (batch on z, at most 65535 by
// the caller's check; the tiles of C on x, at most INT_MAX), then the
// launch in the output type.
template <class T>
cudaError_t run_tile(const Call& c) {
  const long long tiles = static_cast<long long>((c.m + T::BM - 1) / T::BM) *
                          ((c.n + T::BN - 1) / T::BN);
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  if (c.out_type == REPRO_F32)
    return launch_f32<T, float>(c.a, c.b, c.c, c.batch, c.m, c.n, c.k, c.sa,
                                c.lda, c.sb, c.ldb, c.sc, c.ldc, c.stream);
  return launch_f32<T, __nv_bfloat16>(c.a, c.b, c.c, c.batch, c.m, c.n, c.k,
                                      c.sa, c.lda, c.sb, c.ldb, c.sc, c.ldc,
                                      c.stream);
}

// Configuration T's kernel (TMA path, fp32 output) as loaded on the current
// device: registers, local bytes, static and dynamic shared memory, CTAs
// an SM, threads and stages.
template <class T>
cudaError_t info_tile(long long* out) {
  const auto kernel = matmul_f32_kernel<T, true, float>;
  cudaError_t err = allow_smem<T, true, float>();
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel,
                                                      T::THREADS,
                                                      T::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<long long>(attr.localSizeBytes);
  out[2] = static_cast<long long>(attr.sharedSizeBytes);
  out[3] = T::SMEM_BYTES;
  out[4] = ctas;
  out[5] = T::THREADS;
  out[6] = T::STAGES;
  return cudaSuccess;
}

}  // namespace f32

}  // namespace

}  // namespace repro_k1

// The definitions of run_at and info_at for configuration T at its tile:
// the one line of a tile's translation unit.
#define REPRO_K1_TILE(T)                                               \
  namespace repro_k1 {                                                 \
  template <>                                                          \
  cudaError_t run_at<f32::T::BM, f32::T::BN>(const Call& c) {          \
    return f32::run_tile<f32::T>(c);                                   \
  }                                                                    \
  template <>                                                          \
  cudaError_t info_at<f32::T::BM, f32::T::BN>(long long* out) {        \
    return f32::info_tile<f32::T>(out);                                \
  }                                                                    \
  }
