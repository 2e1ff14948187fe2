// K1: blocked matrix product C = A @ B: fp32 inputs on the CUDA cores (this
// file and matmul_f32.cuh), bf16 inputs on the tensor cores (matmul_bf16.cu).
//
// Replaces the reference package's MXU-tiled Pallas kernel
// (src/repro/kernels/matmul/matmul.py, matmul_pallas): the same function --
// (M,K) x (K,N), fp32 accumulation, the result written once in the output
// type -- thought through again for Hopper rather than carried over block by
// block.  The TPU kernel's plan tiles (bm/bn/bk) are a VMEM decision;
// here a plan picks one of a few compiled CTA tiles (below).
//
// What bounds it: at every fp32 product the linalg path launches, 2*M*N*K
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
// The CTA tile is a template parameter (Tile, in matmul_f32.cuh, which holds
// the body); the bullets above describe the default, 128x128, which every
// path that passes no plan or the heuristic one runs.  Five more tiles are compiled, 64x64, 64x128,
// 128x64, 256x64 and 256x128, each with its own thread tile (8x16 or 8x8),
// ring depth (3 or 4 stages) and CTAs an SM; the wrapper maps a plan's
// (bm, bn) onto one (kernels/matmul/ops.py, cta_tile).  The order of the
// sums does not depend on the tile, so every tile gives the same bits.
// Each tile is its own translation unit (matmul_tile_<BM>x<BN>.cu), so that
// the build compiles them in parallel; this file holds the entry points.
//
// bf16 inputs run the bf16 body on the tensor cores (matmul_bf16.cu:
// wgmma on TMA tiles of 128 x 256), which repro_torch.linalg.matmul reaches
// whenever its operands are bf16 (the dispatch hands every local product
// to K1 in the operands' type).  Where TMA cannot load the operands (rows
// or batch starts not 16-byte aligned, K = 0) they run the FFMA body
// below instead (matmul_kernel: 128x128 tiles, BK = 8, staged through
// registers, widened on load); the launcher reports which body ran, and
// the wrapper counts the two apart.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "kernels.h"
#include "matmul_f32.cuh"

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int THREADS = 256;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
using repro_k1::put;

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

}  // namespace

extern "C" cudaError_t repro_matmul(const void* a, const void* b, void* c,
                                    int in_type, int out_type, int batch,
                                    int m, int n, int k, long long sa,
                                    long long lda, long long sb,
                                    long long ldb, long long sc,
                                    long long ldc, int tile_m, int tile_n,
                                    int* body, cudaStream_t stream) {
  const bool known = (in_type == REPRO_F32 || in_type == REPRO_BF16) &&
                     (out_type == REPRO_F32 || out_type == REPRO_BF16);
  if (!known || batch < 1 || batch > 65535 || m < 1 || n < 1 || k < 0)
    return cudaErrorInvalidValue;
  const repro_k1::Call call{a,  b,   c,  out_type, batch, m,  n,     k,
                            sa, lda, sb, ldb,      sc,    ldc, stream};
  if (in_type == REPRO_BF16) {
    // bf16 takes no plan: the default tile request alone
    if (tile_m != BM || tile_n != BN) return cudaErrorInvalidValue;
    const cudaError_t err = repro_k1::run_bf16(call);
    if (err != cudaErrorMisalignedAddress) {
      if (err == cudaSuccess) *body = REPRO_K1_BF16_TC;
      return err;
    }
    if (out_type == REPRO_F32)
      launch<__nv_bfloat16, float>(a, b, c, batch, m, n, k, sa, lda, sb, ldb,
                                   sc, ldc, stream);
    else
      launch<__nv_bfloat16, __nv_bfloat16>(a, b, c, batch, m, n, k, sa, lda,
                                           sb, ldb, sc, ldc, stream);
    *body = REPRO_K1_BF16_FFMA;
    return cudaSuccess;
  }
  const cudaError_t err = repro_k1::with_tile(tile_m, tile_n, [&](auto cta) {
    using C = decltype(cta);
    return repro_k1::run_at<C::BM, C::BN>(call);
  });
  if (err == cudaSuccess) *body = REPRO_K1_F32;
  return err;
}

extern "C" cudaError_t repro_matmul_info(int tile_m, int tile_n,
                                         long long* out) {
  return repro_k1::with_tile(tile_m, tile_n, [&](auto cta) {
    using C = decltype(cta);
    return repro_k1::info_at<C::BM, C::BN>(out);
  });
}
