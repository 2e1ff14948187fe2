// K4: forward GQA attention with an online softmax, in bodies chosen by the
// operands' type: fp32 on the CUDA cores (IEEE FFMA; flash_attention_f32.cu
// holds that body and its note), bf16 on the tensor cores (wgmma) with
// tiles loaded by the Tensor Memory Accelerator (TMA), with a wide body of
// each type above head dim 256. This file holds the launcher and the bf16
// bodies.
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
// wide bodies: head dims above 256, which the reference takes by padding D
// to a multiple of 128 and no config uses; the launcher takes multiples of
// 64 up to 768 (the widest whose tiles fit both types' bodies on an H100).
//  - bf16 (tc::flash_tc_wide_kernel): the tensor-core body's structure
//    (TMA, mbarriers, two consumer warpgroups of 64 query rows, the softmax
//    on ex2 in the accumulator's layout, P rounded to bf16 once), with a
//    producer warpgroup that hands its registers to the consumers
//    (setmaxnreg). What shapes it: a 64-row fp32 O is D / 2 registers a
//    thread of one warpgroup, which past 256 columns no longer fits beside
//    the scores. So each CTA owns one slice of at most 256 of O's columns
//    (m64n64k16 chains, one a 64-column panel), a grid axis walks the
//    slices, and each slice computes S = Q K^T over the whole head dim
//    again: (slices * 2 D + 2 D) / 4 D of the least work, 1.5x at D 384 and
//    512, 2x at 640 and 768. Chosen over one CTA for all slices with S
//    computed once and shared as a bf16 P tile in shared memory: that O is
//    64 x D fp32 in one CTA's registers (160 KB at D 640 of the SM's 256
//    KB) and the scores beside it spill. The query tile (128 rows x D)
//    stays in shared memory; K's and V's 64-row panels stream through a
//    ring of 4 to 8 slots of 8 KB, each freed once the products that read
//    it are done (wgmma.wait_group 1), so loads run ahead of the products.
//  - fp32: the fp32 body (flash_attention_f32.cu) at 4 rows x 8 columns a
//    thread and as many chunks of O's columns as d needs, 64 query rows a
//    CTA up to D 512, 32 above or where 64 would leave SMs without a CTA
//    (repro_k4::launch_f32 picks the tile and reports it).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_attention_f32.cuh"
#include "hopper.cuh"
#include "kernels.h"

namespace {

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// bf16 body: wgmma on the tensor cores, tiles loaded by TMA

namespace tc {

using namespace repro_hopper;

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

// ---------------------------------------------------------------------------
// wide bf16 body: head dims above 256, O's columns in slices (the note at
// the top of this file says why)

constexpr int WIDE_SLICE = 4;                 // panels of O a CTA, at most
constexpr int WIDE_RING = 8;                  // panel slots of the ring
constexpr int WIDE_MIN_RING = 4;              // the fewest a launch takes
constexpr int WIDE_BKV = 64;                  // key / value rows of a tile
// two consumer warpgroups and a producer warpgroup, whose registers go to
// the consumers (setmaxnreg): 64 KB of registers hold 2 x 128 x 232 + 128 x
// 40, where 288 threads without it would get 168 a thread (the launch
// bound counts whole warpgroups) and the consumers' 128 registers of O
// beside the scores spill
constexpr int WIDE_THREADS = CONSUMERS + 128;
constexpr int CONSUMER_REGS = 232;
constexpr int PRODUCER_REGS = 40;
static_assert(2 * 128 * CONSUMER_REGS + 128 * PRODUCER_REGS <= 65536,
              "the register file holds both budgets");
constexpr int PANEL_BYTES = WIDE_BKV * ROW_BYTES;   // 8 KB
constexpr int QPANEL_BYTES = BQ * ROW_BYTES;        // 16 KB

// Shared memory of a CTA at np panels of the head dim and `ring` slots:
// the resident query tile (np panels of 128 rows), the ring, its
// mbarriers (for WIDE_RING slots), slack to align the base.
constexpr size_t wide_bytes(int np, int ring) {
  return static_cast<size_t>(np) * QPANEL_BYTES +
         static_cast<size_t>(ring) * PANEL_BYTES + 8 * (1 + 2 * WIDE_RING) +
         1024;
}

// The ring's slots at np panels within `optin` bytes of shared memory (at
// most WIDE_RING; below WIDE_MIN_RING the launcher refuses the head dim).
int wide_ring(int np, int optin) {
  const long long room = static_cast<long long>(optin) -
                         static_cast<long long>(wide_bytes(np, 0));
  const long long slots = room < 0 ? 0 : room / PANEL_BYTES;
  return static_cast<int>(slots < WIDE_RING ? slots : WIDE_RING);
}

// One CTA: 128 query rows (two consumer warpgroups of 64) of one (batch,
// head) and the slice's nv <= 4 panels of O's columns, from panel p0. The
// producer's one lane loads the query tile once (np panels of 128 rows x 64
// columns) and then, for each key tile, K's np panels and V's nv panels of
// 64 rows into a ring of 8 KB slots, each completing on its "full"
// mbarrier and freed on its "empty" one (one arrival a consumer warp) once
// the products that read it are done. A consumer warpgroup runs S = Q K^T
// as np chained groups of four wgmma m64n64k16 (both operands K-major),
// waiting for the previous group only (wgmma.wait_group 1) so that a
// panel's slot is freed while the next panel's products run; the softmax
// of flash_tc_kernel in the accumulator's layout; then O += P V as nv
// m64n64k16 chains with P (rounded to bf16 once) the register A operand and
// each V panel the MN-major B operand.
__global__ void __launch_bounds__(WIDE_THREADS, 1)
    flash_tc_wide_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         __nv_bfloat16* __restrict__ o, int H, int group,
                         int sq, int skv, int np, int slices, int ring,
                         long long osb, long long osh, long long oss,
                         float scale, int causal) {
  constexpr int NS = WIDE_BKV / 2;          // score registers of a thread
  constexpr int NO = WIDE_SLICE * 32;       // output registers of a thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t s_q = base;
  const uint32_t s_ring = base + np * QPANEL_BYTES;
  const uint32_t bar_q = s_ring + ring * PANEL_BYTES;
  const uint32_t full = bar_q + 8;                  // [ring]
  const uint32_t empty = full + 8 * WIDE_RING;      // [ring]

  const int slice = blockIdx.x % slices;
  const int bh = blockIdx.x / slices;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / group;
  const int p0 = slice * np / slices;               // the slice's panels
  const int nv = (slice + 1) * np / slices - p0;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest rows first
  // key tiles that start at or before the tile's last row (causal), or all
  const int kv_end = causal ? min(skv, q0 + BQ) : skv;
  const int n_kv = (kv_end + WIDE_BKV - 1) / WIDE_BKV;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < ring; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS / 32);   // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // the producer warpgroup: one lane issues every load, in the order the
    // consumers read them
    reg_dealloc<PRODUCER_REGS>();
    if (tid == CONSUMERS) {
      mbar_expect_tx(bar_q, np * QPANEL_BYTES);
      for (int p = 0; p < np; ++p)
        tma_load(s_q + p * QPANEL_BYTES, &tq, bar_q, p * PANEL, q0, h, b);
      int slot = 0, used = 0;
      uint32_t phase = 0;
      for (int t = 0; t < n_kv; ++t)
        for (int p = 0; p < np + nv; ++p) {
          if (used++ >= ring)   // the panel that held this slot is done
            mbar_wait(empty + 8 * slot, phase ^ 1);
          mbar_expect_tx(full + 8 * slot, PANEL_BYTES);
          if (p < np)
            tma_load(s_ring + slot * PANEL_BYTES, &tk, full + 8 * slot,
                     p * PANEL, t * WIDE_BKV, hk, b);
          else
            tma_load(s_ring + slot * PANEL_BYTES, &tv, full + 8 * slot,
                     (p0 + p - np) * PANEL, t * WIDE_BKV, hk, b);
          if (++slot == ring) {
            slot = 0;
            phase ^= 1;
          }
        }
    }
    return;
  }

  // a consumer warpgroup: 64 query rows
  reg_alloc<CONSUMER_REGS>();
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
  int slot = 0;
  uint32_t phase = 0;
  int held = 0;                      // the slot of the group in flight

  mbar_wait(bar_q, 0);
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * WIDE_BKV;

    // S = Q K^T over np panels of 64 columns, four steps of 16 each
    fence_regs<NS>(sc);
    for (int p = 0; p < np; ++p) {
      mbar_wait(full + 8 * slot, phase);
      wg_fence();
      const uint32_t kp = s_ring + slot * PANEL_BYTES;
      const uint32_t qp = q_rows + p * QPANEL_BYTES;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<64>(sc, desc(qp + kk * 32, 16, 1024),
                     desc(kp + kk * 32, 16, 1024), p > 0 || kk > 0);
      wg_commit();
      wg_wait<1>();   // the previous panel's products are done ...
      if (p > 0 && lane == 0) mbar_arrive(empty + 8 * held);   // ... free it
      held = slot;
      if (++slot == ring) {
        slot = 0;
        phase ^= 1;
      }
    }
    wg_wait<0>();
    fence_regs<NS>(sc);
    if (lane == 0) mbar_arrive(empty + 8 * held);

    // the mask, then the reference's online update, two rows a thread; the
    // scale enters the exponent in fp32: exp(scale (s - m))
    const bool edge =
        k0 + WIDE_BKV > skv || (causal && k0 + WIDE_BKV - 1 > row_min);
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
      const float e0 = exp2_fast(fmaf(sc[i], sl2, -ml));
      const float e1 = exp2_fast(fmaf(sc[i + 1], sl2, -ml));
      if (i & 2)
        ps1 += e0 + e1;
      else
        ps0 += e0 + e1;
      pa[i / 2] = pack_bf16(e0, e1);
    }
    l0 = l0 * alpha0 + ps0;
    l1 = l1 * alpha1 + ps1;
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] *= (i & 2) ? alpha1 : alpha0;

    // O += P V: the slice's panels, four steps of 16 keys each
#pragma unroll
    for (int j = 0; j < WIDE_SLICE; ++j) {
      if (j >= nv) break;
      mbar_wait(full + 8 * slot, phase);
      wg_fence();
      const uint32_t vp = s_ring + slot * PANEL_BYTES;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<64>(acc + 32 * j, &pa[4 * kk],
                     desc(vp + kk * 16 * ROW_BYTES, PANEL_BYTES, 1024));
      wg_commit();
      wg_wait<1>();
      if (j > 0 && lane == 0) mbar_arrive(empty + 8 * held);
      held = slot;
      if (++slot == ring) {
        slot = 0;
        phase ^= 1;
      }
    }
    wg_wait<0>();
    fence_regs<NO>(acc);
    if (lane == 0) mbar_arrive(empty + 8 * held);
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
  for (int j = 0; j < WIDE_SLICE; ++j) {
    if (j >= nv) break;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = (p0 + j) * PANEL + 8 * jj + cq;
      const float* a = acc + 32 * j + 4 * jj;
      if (r0 < sq)
        *reinterpret_cast<__nv_bfloat162*>(o_row + r0 * oss + col) =
            __floats2bfloat162_rn(a[0] / li0, a[1] / li0);
      if (r1 < sq)
        *reinterpret_cast<__nv_bfloat162*>(o_row + r1 * oss + col) =
            __floats2bfloat162_rn(a[2] / li1, a[3] / li1);
    }
  }
}

cudaError_t launch_wide(const void* q, const void* k, const void* v, void* o,
                        int batch, int heads, int kv_heads, int sq, int skv,
                        int d, const long long* st, float scale, int causal,
                        int optin, cudaStream_t stream) {
  const int np = d / PANEL;
  const int ring = wide_ring(np, optin);
  if (ring < WIDE_MIN_RING) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, d, sq, heads, batch, st[2], st[1], st[0], BQ) ||
      !tensor_map(&tk, k, d, skv, kv_heads, batch, st[5], st[4], st[3],
                  WIDE_BKV) ||
      !tensor_map(&tv, v, d, skv, kv_heads, batch, st[8], st[7], st[6],
                  WIDE_BKV))
    return cudaErrorMisalignedAddress;
  const size_t smem = wide_bytes(np, ring);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_tc_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int slices = (np + WIDE_SLICE - 1) / WIDE_SLICE;
  const dim3 grid(batch * heads * slices, (sq + BQ - 1) / BQ);
  flash_tc_wide_kernel<<<grid, WIDE_THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), heads, heads / kv_heads, sq,
      skv, np, slices, ring, st[9], st[10], st[11], scale, causal);
  return cudaSuccess;
}

}  // namespace tc


// The widest head dim above 256 that both wide bodies take: a multiple of
// 64 up to WIDE_MAX (the fp32 body's registers: 3 chunks of 256 columns)
// whose tiles fit the device's opt-in shared memory of a block, with the
// bf16 body's ring at WIDE_MIN_RING slots or more; 0 if the device cannot
// be read.
constexpr int WIDE_MAX = 768;

int max_head_dim(int* optin_out = nullptr) {
  int dev = 0;
  int optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  if (optin_out) *optin_out = optin;
  int widest = 0;
  for (int d = 320; d <= WIDE_MAX; d += 64)
    if (tc::wide_ring(d / tc::PANEL, optin) >= tc::WIDE_MIN_RING &&
        repro_k4::f32_bytes(d) <= static_cast<size_t>(optin))
      widest = d;
  return widest;
}

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

}  // namespace

extern "C" int repro_flash_attention_max_head_dim() { return max_head_dim(); }

extern "C" cudaError_t repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int batch, int heads, int kv_heads, int sq, int skv, int d,
    const long long* strides, float scale, int causal, int* body,
    cudaStream_t stream) {
  int optin = 0;
  if (d > 256 && (d % 64 != 0 || d > max_head_dim(&optin)))
    return cudaErrorInvalidValue;
  if (d <= 256 && d != 64 && d != 96 && d != 128 && d != 256)
    return cudaErrorInvalidValue;
  if (dtype != REPRO_BF16)
    return repro_k4::launch_f32(q, k, v, o, batch, heads, kv_heads, sq, skv,
                                d, strides, scale, causal, body, stream);
  *body = d > 256 ? REPRO_K4_BF16_TC_WIDE : REPRO_K4_BF16_TC;
  if (d > 256)
    return tc::launch_wide(q, k, v, o, batch, heads, kv_heads, sq, skv, d,
                           strides, scale, causal, optin, stream);
  return launch_bf16(q, k, v, o, batch, heads, kv_heads, sq, skv, d, strides,
                     scale, causal, stream);
}
