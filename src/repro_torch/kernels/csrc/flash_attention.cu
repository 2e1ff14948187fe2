// K4: forward GQA attention with an online softmax, in two bodies chosen by
// the operands' type: fp32 on the CUDA cores (FFMA), bf16 on the tensor
// cores (wgmma) with tiles loaded by the Tensor Memory Accelerator (TMA).
//
// Replaces the reference package's Pallas flash kernel
// (src/repro/kernels/flash_attention/flash_attention.py,
// flash_attention_pallas): the same function -- softmax(q k^T * scale) v per
// query head, the kv head being h / (H / KV), causal or not, columns at or
// past the kv length masked to -1e30, a running max and sum per row with an
// fp32 accumulator, a row whose sum is 0 divided by 1, the result written in
// q's type -- thought through again for Hopper rather than carried over.
//
// What bounds it: per query row it does 4 * D operations for every key it
// sees and reads each key and value row once per query tile, so at the
// prefill's shapes (S = 4096, D = 128) it is far above the card's
// operations-per-byte balance and bound by operations: 989 TFLOP/s for bf16
// operands on the tensor cores, 67 TFLOP/s of fp32 FFMA.
//
// fp32 body (flash_kernel): IEEE fp32 throughout, as the repo's fp32 rule
// wants; the tensor cores take fp32 only as TF32. One CTA of 256 threads
// owns a 64-row query tile of one (batch, head) and walks the key/value rows
// in tiles of 64. The TPU kernel's sequential kv grid axis becomes this
// loop; its plan blocks (bq/bkv) are VMEM choices and set nothing here.
// Tiles wholly above the causal diagonal are never visited, which halves the
// work at Sq = Skv, and the CTAs with the longest causal rows are scheduled
// first. The query tile (scaled in fp32 after widening, as the reference
// scales) and the key tile sit transposed in shared memory so that each
// thread reads float4 rows of both: a thread owns a 4x4 block of scores and
// does 16 FFMAs per two shared loads. The scores' row max and sum are
// reduced over the 16 threads of a row with warp shuffles; the
// probabilities go through shared memory (transposed) into the P.V product,
// where a thread owns 4 rows x D/16 columns of the accumulator. The value
// tile reuses the key tile's buffer, so a CTA needs 85 KB at D = 128 and two
// CTAs fit an SM (153 KB and one CTA at D = 256). Ragged edges are
// zero-filled on load and masked on store.
//
// bf16 body (flash_tc_kernel): bf16 operands on the tensor cores with fp32
// sums, the arithmetic the TPU's MXU gives the reference at its default
// precision. One CTA owns 128 query rows of one (batch, head): two consumer
// warpgroups of 64 rows each and one producer warp. The producer loads the
// query tile once and the 128-row key and value tiles through a 2-stage
// ring in shared memory with TMA, each tile completing on its own mbarrier,
// so the next tile streams in while the current one is multiplied; TMA fills
// rows past the sequence with zeros, and its 128-byte swizzle is the layout
// wgmma reads without bank conflicts. S = Q K^T is a wgmma m64n128k16 chain
// with both operands in shared memory (K-major), q entering exactly as
// given; the mask follows, and the scale enters in fp32 in the exponent,
// exp(scale (s - m)) = 2^(scale log2(e) (s - m)), one ex2 a score on the
// special-function unit. The online softmax runs in registers in the
// accumulator's layout: a row's max and sum are reduced over the four
// threads that share it with shuffles, l is summed in fp32. P is rounded to
// bf16 once and is the register A operand of O += P V (wgmma m64nDk16, V
// from shared memory as the MN-major B operand); O stays in fp32 registers
// and is divided by l (0 -> 1) and rounded to bf16 only at the end. Head
// dims of 96 are padded to 128 columns in shared memory by the TMA's zero
// fill. At D = 256 (taken simple, not tuned) the key and value tiles are 64
// rows, the scores an m64n64k16 chain, and O += P V two m64n128k16 products
// on the two halves of V's columns: the 64 x 256 fp32 accumulator is 128
// registers a thread. The grid runs the longest causal rows of every head first.
// Tried and not kept (PERF.md): an mma.sync body (slower), 64-row key
// tiles, and overlapping one tile's softmax with the other products (within
// a warpgroup, or ping-pong between the two), which gained too little to
// pay for their code.
//
// wide body (flash_wide_kernel): head dims above 256, which the reference
// takes by padding D to a multiple of 128 and no config uses; taken simple,
// for either type. The fp32 body's tiles (64 query rows, 64 keys, a 4x4
// block of scores a thread) with D a runtime loop over 64-column slices:
// the scores sum over the slices of q and k loaded (widened to fp32, q
// scaled) into shared memory one slice at a time, and the 64 x D fp32
// accumulator lives in shared memory, each element owned by one thread,
// rescaled and updated slice by slice as V's slices arrive. Shared memory
// is 51 KB of tiles plus 256 bytes a column of D, so the device's opt-in
// limit (227 KB on an H100) bounds D at 704; the launcher refuses wider.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "kernels.h"

namespace {

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// fp32 body: FFMA on the CUDA cores

constexpr int BQ = 64;          // query rows of a CTA
constexpr int BKV = 64;         // key / value rows of one step
constexpr int THREADS = 256;    // 16 x 16: ty owns 4 rows, tx 4 columns
constexpr int LDT = BQ + 4;     // row stride of the transposed tiles

template <int D>
constexpr size_t smem_bytes() {
  // Qt [D][LDT], the k (transposed) / v buffer [D][LDT], Pt [BKV][LDT]
  return sizeof(float) * (2 * D * LDT + BKV * LDT);
}

template <int D>
__global__ void __launch_bounds__(THREADS, D <= 128 ? 2 : 1)
    flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int H,
                 int group, int sq, int skv, long long qsb, long long qsh,
                 long long qss, long long ksb, long long ksh, long long kss,
                 long long vsb, long long vsh, long long vss, long long osb,
                 long long osh, long long oss, float scale, int causal) {
  static_assert(D % 32 == 0 && D <= 256, "head dim");
  constexpr int NC = D / 16;     // accumulator columns of a thread
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;              // [D][LDT]  q tile, transposed and scaled
  float* KV = Qt + D * LDT;      // [D][LDT] k tile transposed; [BKV][D] v
  float* Pt = KV + D * LDT;      // [BKV][LDT] probabilities, transposed

  const int n_q = (sq + BQ - 1) / BQ;
  const int q0 = (n_q - 1 - blockIdx.x) * BQ;   // longest causal rows first
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int hk = h / group;
  q += b * qsb + h * qsh;
  k += b * ksb + hk * ksh;
  v += b * vsb + hk * vsh;
  o += b * osb + h * osh;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D;
    const int d = e % D;
    const int row = q0 + r;
    Qt[d * LDT + r] = row < sq ? q[row * qss + d] * scale : 0.f;
  }

  float acc[4][NC];
  float m[4];
  float l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // key tiles that start at or before the tile's last row (causal), or all
  const int kv_end = causal ? min(skv, q0 + BQ) : skv;
  const int n_kv = (kv_end + BKV - 1) / BKV;
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * BKV;
    __syncthreads();   // the last step's reads of KV and Pt are done
    for (int e = tid; e < BKV * D; e += THREADS) {
      const int r = e / D;
      const int d = e % D;
      const int col = k0 + r;
      KV[d * LDT + r] = col < skv ? k[col * kss + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * LDT + ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&KV[d * LDT + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    // mask, then the online-softmax update of the reference, row by row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        const bool valid = col < skv && (!causal || row >= col);
        s[i][j] = valid ? s[i][j] : NEG_INF;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        ps += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * alpha + ps;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Pt[(tx * 4 + j) * LDT + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();   // every thread is done with the key tile

    for (int e = tid; e < BKV * D; e += THREADS) {
      const int r = e / D;
      const int d = e % D;
      const int col = k0 + r;
      KV[r * D + d] = col < skv ? v[col * vss + d] : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(&Pt[j * LDT + ty * 4]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int g = 0; g < D / 32; ++g) {
        const float2 w =
            *reinterpret_cast<const float2*>(&KV[j * D + g * 32 + tx * 2]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][2 * g] = fmaf(pv[i], w.x, acc[i][2 * g]);
          acc[i][2 * g + 1] = fmaf(pv[i], w.y, acc[i][2 * g + 1]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = (c / 2) * 32 + tx * 2 + (c & 1);
      o[row * oss + col] = acc[i][c] / li;
    }
  }
}

template <int D>
cudaError_t launch_ffma(const float* q, const float* k, const float* v,
                        float* o, int batch, int heads, int kv_heads, int sq,
                        int skv, const long long* st, float scale, int causal,
                        cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, batch * heads);
  flash_kernel<D><<<grid, THREADS, smem, stream>>>(
      q, k, v, o, heads, heads / kv_heads, sq, skv, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale,
      causal);
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// bf16 body: wgmma on the tensor cores, tiles loaded by TMA

namespace tc {

constexpr int BQ = 128;                   // query rows: two warpgroups of 64
constexpr int STAGES = 2;                 // key / value tiles in flight
constexpr int CONSUMERS = 256;            // the two warpgroups' threads
constexpr int THREADS = CONSUMERS + 32;   // and one producer warp
constexpr int PANEL = 64;                 // bf16 columns of a 128-byte row
constexpr int ROW_BYTES = 128;
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory: the query tile, then STAGES key and STAGES value tiles,
// each as DP / 64 panels of (rows x 128 bytes) in the TMA's 128-byte
// swizzle (1024-byte aligned), then the mbarriers. At D = 256 the key and
// value tiles are 64 rows, so that the ring fits beside the 64 KB query
// tile (193 KB in all).
template <int D>
struct Layout {
  static constexpr int DP = D <= 64 ? 64 : D <= 128 ? 128 : 256;  // columns
  static constexpr int BKV = DP <= 128 ? 128 : 64;   // key / value rows
  static constexpr int Q_BYTES = BQ * DP * 2;
  static constexpr int KV_BYTES = BKV * DP * 2;
  static constexpr int K_OFFSET = Q_BYTES;
  static constexpr int V_OFFSET = K_OFFSET + STAGES * KV_BYTES;
  static constexpr int BAR_OFFSET = V_OFFSET + STAGES * KV_BYTES;
  // + 1024 bytes of slack to align the base
  static constexpr size_t BYTES = BAR_OFFSET + 8 * (1 + 3 * STAGES) + 1024;
};

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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
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

// One box of (64 columns, rows, 1, 1) at (c0, c1, c2, c3) into shared memory,
// completing on the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 = B128.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving register accesses across the asynchronous
// products that read and write these registers.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// 2^x on the special-function unit, one instruction; results below the
// smallest normal float flush to 0
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

template <int N>
__device__ void wgmma_ss(float* d, uint64_t da, uint64_t db, int accumulate);
template <int N>
__device__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db);

// D(64 x 128) (+)= A(64 x 16) B(128 x 16)^T, both K-major in shared memory.
template <>
__device__ __forceinline__ void wgmma_ss<128>(float* d, uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D(64 x 64) (+)= A(64 x 16) B(64 x 16)^T, both K-major in shared memory.
template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D(64 x 64) += A(64 x 16, registers) B(16 x 64), B MN-major in shared
// memory.
template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 128) += A(64 x 16, registers) B(16 x 128), B MN-major in shared
// memory.
template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// The thread's rows are r0 and r0 + 8 of its warp's 16; in the accumulator
// of an m64nN product, register i holds row r0 + 8 * ((i >> 1) & 1) and
// column 8 * (i >> 2) + 2 * (lane % 4) + (i & 1).
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    __nv_bfloat16* __restrict__ o, int H, int group, int sq,
                    int skv, long long osb, long long osh, long long oss,
                    float scale, int causal) {
  using L = Layout<D>;
  constexpr int DP = L::DP;
  constexpr int BKV = L::BKV;
  constexpr int NS = BKV / 2;   // score registers of a thread
  constexpr int NO = DP / 2;    // output registers of a thread
  // columns of one P V product: the 64 x 256 accumulator of D = 256 takes
  // two m64n128 products, registers 0-63 and 64-127 of the m64n256 layout
  constexpr int NW = DP <= 128 ? DP : 128;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t s_q = base;
  const uint32_t s_k = base + L::K_OFFSET;
  const uint32_t s_v = base + L::V_OFFSET;
  const uint32_t bar_q = base + L::BAR_OFFSET;
  const uint32_t bar_k = bar_q + 8;                  // [STAGES]
  const uint32_t bar_v = bar_k + 8 * STAGES;         // [STAGES]
  const uint32_t bar_free = bar_v + 8 * STAGES;      // [STAGES]

  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest rows first
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int hk = h / group;
  // key tiles that start at or before the tile's last row (causal), or all
  const int kv_end = causal ? min(skv, q0 + BQ) : skv;
  const int n_kv = (kv_end + BKV - 1) / BKV;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_free + 8 * s, CONSUMERS / 32);   // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // the producer warp: one lane issues every load
    if (tid == CONSUMERS) {
      mbar_expect_tx(bar_q, L::Q_BYTES);
      for (int p = 0; p < DP / PANEL; ++p)
        tma_load(s_q + p * BQ * ROW_BYTES, &tq, bar_q, p * PANEL, q0, h, b);
      for (int t = 0; t < n_kv; ++t) {
        const int s = t % STAGES;
        const uint32_t off = s * L::KV_BYTES;
        if (t >= STAGES)   // the tile that used this stage is done
          mbar_wait(bar_free + 8 * s, ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(bar_k + 8 * s, L::KV_BYTES);
        for (int p = 0; p < DP / PANEL; ++p)
          tma_load(s_k + off + p * BKV * ROW_BYTES, &tk, bar_k + 8 * s,
                   p * PANEL, t * BKV, hk, b);
        mbar_expect_tx(bar_v + 8 * s, L::KV_BYTES);
        for (int p = 0; p < DP / PANEL; ++p)
          tma_load(s_v + off + p * BKV * ROW_BYTES, &tv, bar_v + 8 * s,
                   p * PANEL, t * BKV, hk, b);
      }
    }
    return;
  }

  // a consumer warpgroup: 64 query rows
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int row_min = q0 + wg * 64;
  const int r0 = row_min + warp * 16 + lane / 4;
  const int r1 = r0 + 8;
  const int cq = 2 * (lane % 4);
  const uint32_t q_rows = s_q + wg * 64 * ROW_BYTES;
  const float sl2 = scale * LOG2E;   // exp(scale x) = 2^(sl2 x)

  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  float sc[NS];                      // raw scores of a key tile
#pragma unroll
  for (int i = 0; i < NS; ++i) sc[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF;  // running max of the two rows (raw)
  float l0 = 0.f, l1 = 0.f;          // this thread's part of the sums

  mbar_wait(bar_q, 0);
  for (int t = 0; t < n_kv; ++t) {
    const int s = t % STAGES;
    const uint32_t parity = (t / STAGES) & 1;
    const uint32_t off = s * L::KV_BYTES;
    const int k0 = t * BKV;

    // S = Q K^T over D / 16 steps of 16 columns; a panel holds four
    mbar_wait(bar_k + 8 * s, parity);
    fence_regs<NS>(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;   // bytes into the panel row
      wgmma_ss<BKV>(sc,
                    desc(q_rows + (kk / 4) * BQ * ROW_BYTES + col, 16, 1024),
                    desc(s_k + off + (kk / 4) * BKV * ROW_BYTES + col, 16,
                         1024),
                    kk > 0);
    }
    wg_commit();
    wg_wait();
    fence_regs<NS>(sc);

    // the mask, then the reference's online update, two rows a thread; the
    // scale enters the exponent in fp32: exp(scale (s - m))
    const bool edge = k0 + BKV > skv || (causal && k0 + BKV - 1 > row_min);
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      if (edge) {
        const int col = k0 + 8 * (i >> 2) + cq + (i & 1);
        const int row = (i & 2) ? r1 : r0;
        if (col >= skv || (causal && col > row)) sc[i] = NEG_INF;
      }
      if (i & 2)
        mx1 = fmaxf(mx1, sc[i]);
      else
        mx0 = fmaxf(mx0, sc[i]);
    }
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2_fast((m0 - mn0) * sl2);
    const float alpha1 = exp2_fast((m1 - mn1) * sl2);
    m0 = mn0;
    m1 = mn1;
    const float ml0 = mn0 * sl2;
    const float ml1 = mn1 * sl2;
    // P in bf16 pairs: registers 4 kk .. 4 kk + 3 are the A fragment of
    // the kk-th 16-key step of P V
    uint32_t pa[NS / 2];
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int i = 0; i < NS; i += 2) {
      const float ml = (i & 2) ? ml1 : ml0;
      const float p0 = exp2_fast(fmaf(sc[i], sl2, -ml));
      const float p1 = exp2_fast(fmaf(sc[i + 1], sl2, -ml));
      if (i & 2)
        ps1 += p0 + p1;
      else
        ps0 += p0 + p1;
      pa[i / 2] = pack_bf16(p0, p1);
    }
    l0 = l0 * alpha0 + ps0;
    l1 = l1 * alpha1 + ps1;
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] *= (i & 2) ? alpha1 : alpha0;

    // O += P V over BKV / 16 steps of 16 keys
    mbar_wait(bar_v + 8 * s, parity);
    fence_regs<NO>(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
      for (int hh = 0; hh < DP / NW; ++hh)
        wgmma_rs<NW>(acc + hh * (NW / 2), &pa[4 * kk],
                     desc(s_v + off + hh * (NW / PANEL) * BKV * ROW_BYTES +
                              kk * 16 * ROW_BYTES,
                          BKV * ROW_BYTES, 1024));
    wg_commit();
    wg_wait();
    fence_regs<NO>(acc);
    if (lane == 0) mbar_arrive(bar_free + 8 * s);
  }

#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const float li0 = l0 == 0.f ? 1.f : l0;
  const float li1 = l1 == 0.f ? 1.f : l1;
  __nv_bfloat16* o_row = o + b * osb + h * osh;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + cq;
    if (r0 < sq)
      *reinterpret_cast<__nv_bfloat162*>(o_row + r0 * oss + col) =
          __floats2bfloat162_rn(acc[4 * j] / li0, acc[4 * j + 1] / li0);
    if (r1 < sq)
      *reinterpret_cast<__nv_bfloat162*>(o_row + r1 * oss + col) =
          __floats2bfloat162_rn(acc[4 * j + 2] / li1, acc[4 * j + 3] / li1);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime so that
// the extension need not link libcuda.
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

// The TMA map of one bf16 operand: (d, rows, heads, batch) with element
// strides (1, row, head, batch), boxes of 64 columns by box_rows rows, the
// 128-byte swizzle, zeros outside. False if TMA cannot take the operand:
// its address must be 16-byte aligned and its strides multiples of 16 bytes.
bool tensor_map(CUtensorMap* map, const void* ptr, int d, int rows,
                int heads, int batch, long long row_stride,
                long long head_stride, long long batch_stride, int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
    return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const long long given[3] = {row_stride, head_stride, batch_stride};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    // the stride of an axis of extent 1 is never used
    const long long st = dims[i + 1] == 1 ? 8 : given[i];
    if (st <= 0 || st % 8 != 0 || st >= (1ll << 39)) return false;
    strides[i] = static_cast<cuuint64_t>(st) * 2;
  }
  const cuuint32_t box[4] = {PANEL, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}


template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int batch, int heads, int kv_heads, int sq, int skv,
                   const long long* st, float scale, int causal,
                   cudaStream_t stream) {
  constexpr int BKV = Layout<D>::BKV;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, D, sq, heads, batch, st[2], st[1], st[0], BQ) ||
      !tensor_map(&tk, k, D, skv, kv_heads, batch, st[5], st[4], st[3],
                  BKV) ||
      !tensor_map(&tv, v, D, skv, kv_heads, batch, st[8], st[7], st[6], BKV))
    return cudaErrorMisalignedAddress;
  constexpr size_t smem = Layout<D>::BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * heads, (sq + BQ - 1) / BQ);
  flash_tc_kernel<D><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), heads, heads / kv_heads, sq,
      skv, st[9], st[10], st[11], scale, causal);
  return cudaSuccess;
}

}  // namespace tc

// ---------------------------------------------------------------------------
// wide body: head dims above 256 (the wrapper pads D to a multiple of 128),
// in either type, D a runtime loop over 64-column slices

namespace wide {

constexpr int BQ = 64;          // query rows of a CTA
constexpr int BKV = 64;         // key / value rows of one step
constexpr int SLICE = 64;       // head-dim columns of one pass
constexpr int THREADS = 256;    // 16 x 16: ty owns 4 rows, tx 4 columns
constexpr int LDT = BQ + 4;     // row stride of the transposed tiles

// Qt [SLICE][LDT] and the k slice (transposed) or v slice [SLICE][LDT],
// Pt [BKV][LDT], then the accumulator O [BQ][d]
size_t smem_bytes(int d) {
  return sizeof(float) *
         (3 * SLICE * LDT + static_cast<size_t>(BQ) * static_cast<size_t>(d));
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    flash_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int H,
                      int group, int sq, int skv, int d, long long qsb,
                      long long qsh, long long qss, long long ksb,
                      long long ksh, long long kss, long long vsb,
                      long long vsh, long long vss, long long osb,
                      long long osh, long long oss, float scale,
                      int causal) {
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;              // [SLICE][LDT]  q slice, transposed, scaled
  float* KV = Qt + SLICE * LDT;  // [SLICE][LDT] k slice transposed; v slice
  float* Pt = KV + SLICE * LDT;  // [BKV][LDT] probabilities, transposed
  float* O = Pt + BKV * LDT;     // [BQ][d] the fp32 accumulator

  const int n_q = (sq + BQ - 1) / BQ;
  const int q0 = (n_q - 1 - blockIdx.x) * BQ;   // longest causal rows first
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int hk = h / group;
  q += b * qsb + h * qsh;
  k += b * ksb + hk * ksh;
  v += b * vsb + hk * vsh;
  o += b * osb + h * osh;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  // a thread owns rows ty * 4 + i and, in every slice, columns tx * 4 + j
  // of O: no other thread reads or writes them
  for (int e = tid; e < BQ * d; e += THREADS) O[e] = 0.f;
  float m[4];
  float l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
  }

  const int kv_end = causal ? min(skv, q0 + BQ) : skv;
  const int n_kv = (kv_end + BKV - 1) / BKV;
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * BKV;
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c0 = 0; c0 < d; c0 += SLICE) {
      __syncthreads();   // the last reads of Qt and KV are done
      for (int e = tid; e < BQ * SLICE; e += THREADS) {
        const int r = e / SLICE;
        const int c = e % SLICE;
        const int row = q0 + r;
        const int col = k0 + r;
        Qt[c * LDT + r] = row < sq ? widen(q[row * qss + c0 + c]) * scale
                                   : 0.f;
        KV[c * LDT + r] = col < skv ? widen(k[col * kss + c0 + c]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < SLICE; ++c) {
        const float4 a =
            *reinterpret_cast<const float4*>(&Qt[c * LDT + ty * 4]);
        const float4 w =
            *reinterpret_cast<const float4*>(&KV[c * LDT + tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], wv[j], s[i][j]);
      }
    }

    // mask, then the online-softmax update, row by row
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        const bool valid = col < skv && (!causal || row >= col);
        s[i][j] = valid ? s[i][j] : NEG_INF;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      alpha[i] = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        ps += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * alpha[i] + ps;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Pt[(tx * 4 + j) * LDT + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);

    // O = alpha O + P V, one slice of V's columns at a time
    for (int c0 = 0; c0 < d; c0 += SLICE) {
      __syncthreads();   // Pt is written; the last reads of KV are done
      for (int e = tid; e < BKV * SLICE; e += THREADS) {
        const int r = e / SLICE;
        const int c = e % SLICE;
        const int col = k0 + r;
        KV[r * SLICE + c] = col < skv ? widen(v[col * vss + c0 + c]) : 0.f;
      }
      __syncthreads();
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(
            &O[(ty * 4 + i) * d + c0 + tx * 4]);
        acc[i][0] = x.x * alpha[i];
        acc[i][1] = x.y * alpha[i];
        acc[i][2] = x.z * alpha[i];
        acc[i][3] = x.w * alpha[i];
      }
#pragma unroll 4
      for (int jj = 0; jj < BKV; ++jj) {
        const float4 p =
            *reinterpret_cast<const float4*>(&Pt[jj * LDT + ty * 4]);
        const float4 w =
            *reinterpret_cast<const float4*>(&KV[jj * SLICE + tx * 4]);
        const float pv[4] = {p.x, p.y, p.z, p.w};
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(pv[i], wv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(&O[(ty * 4 + i) * d + c0 + tx * 4]) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
    for (int c0 = 0; c0 < d; c0 += SLICE)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx * 4 + j;
        put(&o[row * oss + col], O[(ty * 4 + i) * d + col] / li);
      }
  }
}

// The widest d (a multiple of SLICE) whose tiles fit the device's opt-in
// shared memory of a block; 0 if the device cannot be read.
int max_head_dim() {
  int dev = 0;
  int optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  const long long room =
      static_cast<long long>(optin) - static_cast<long long>(smem_bytes(0));
  return room <= 0 ? 0
                   : static_cast<int>(room / (sizeof(float) * BQ) / SLICE *
                                      SLICE);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int batch, int heads, int kv_heads, int sq, int skv, int d,
                   const long long* st, float scale, int causal,
                   cudaStream_t stream) {
  if (d % SLICE != 0 || d > max_head_dim()) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(d);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, batch * heads);
  flash_wide_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), heads, heads / kv_heads,
      sq, skv, d, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], scale, causal);
  return cudaSuccess;
}

}  // namespace wide

cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int batch, int heads, int kv_heads, int sq, int skv,
                        int d, const long long* st, float scale, int causal,
                        cudaStream_t stream) {
  switch (d) {
    case 64:
      return tc::launch<64>(q, k, v, o, batch, heads, kv_heads, sq, skv, st,
                            scale, causal, stream);
    case 96:
      return tc::launch<96>(q, k, v, o, batch, heads, kv_heads, sq, skv, st,
                            scale, causal, stream);
    case 128:
      return tc::launch<128>(q, k, v, o, batch, heads, kv_heads, sq, skv, st,
                             scale, causal, stream);
    default:
      return tc::launch<256>(q, k, v, o, batch, heads, kv_heads, sq, skv, st,
                             scale, causal, stream);
  }
}

cudaError_t launch_fp32(const void* q, const void* k, const void* v, void* o,
                        int batch, int heads, int kv_heads, int sq, int skv,
                        int d, const long long* st, float scale, int causal,
                        cudaStream_t stream) {
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  switch (d) {
    case 64:
      return launch_ffma<64>(qf, kf, vf, of, batch, heads, kv_heads, sq, skv,
                             st, scale, causal, stream);
    case 96:
      return launch_ffma<96>(qf, kf, vf, of, batch, heads, kv_heads, sq, skv,
                             st, scale, causal, stream);
    case 128:
      return launch_ffma<128>(qf, kf, vf, of, batch, heads, kv_heads, sq,
                              skv, st, scale, causal, stream);
    default:
      return launch_ffma<256>(qf, kf, vf, of, batch, heads, kv_heads, sq,
                              skv, st, scale, causal, stream);
  }
}

}  // namespace

extern "C" int repro_flash_attention_max_head_dim() {
  return wide::max_head_dim();
}

extern "C" cudaError_t repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int batch, int heads, int kv_heads, int sq, int skv, int d,
    const long long* strides, float scale, int causal, cudaStream_t stream) {
  if (d > 256) {
    if (dtype == REPRO_BF16)
      return wide::launch<__nv_bfloat16>(q, k, v, o, batch, heads, kv_heads,
                                         sq, skv, d, strides, scale, causal,
                                         stream);
    return wide::launch<float>(q, k, v, o, batch, heads, kv_heads, sq, skv,
                               d, strides, scale, causal, stream);
  }
  if (d != 64 && d != 96 && d != 128 && d != 256)
    return cudaErrorInvalidValue;
  if (dtype == REPRO_BF16)
    return launch_bf16(q, k, v, o, batch, heads, kv_heads, sq, skv, d,
                       strides, scale, causal, stream);
  return launch_fp32(q, k, v, o, batch, heads, kv_heads, sq, skv, d, strides,
                     scale, causal, stream);
}
