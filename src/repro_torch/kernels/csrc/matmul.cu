// K1: blocked matrix product C = A @ B on the CUDA cores (fp32 FFMA).
//
// Replaces the reference package's MXU-tiled Pallas kernel
// (src/repro/kernels/matmul/matmul.py, matmul_pallas): the same function --
// (M,K) x (K,N), fp32 accumulation, the result written once in the output
// type -- thought through again for Hopper rather than carried over block by
// block.
//
// What bounds it: at the main path's shapes (n >= 1024 on every edge) a
// product does 2*M*N*K operations on M*K + K*N + M*N elements, far above the
// card's operations-per-byte balance, so it is bound by operations: IEEE
// fp32 FFMA at 67 TFLOP/s (no TF32: the dispatch gates need relative
// error < 1e-4).
//
// What the design does about it: each block of 256 threads owns a 128x128
// tile of C and walks K in steps of 8.  The A and B slices of a step are
// staged in shared memory (A transposed, so both are read as float4 rows),
// double-buffered: the next step's slices are loaded into registers before
// the current step's products and stored after them, one barrier per step.
// Each thread keeps an 8x8 register tile of C (two 4-wide column groups 64
// apart and two 4-high row groups 64 apart, so a quarter-warp's float4
// reads hit 32 distinct banks) and does 64 FFMAs per 4 shared loads.  The
// TPU kernel's plan tiles (bm/bn/bk) are a VMEM decision and set nothing
// here: the CTA tile is this kernel's own compile-time choice.  Ragged
// edges are masked in the loads (zeros) and in the stores, so no operand is
// padded.  bf16 inputs are widened with __bfloat162float on load.
// Not yet used: wgmma and TMA (the tensor cores) -- later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // namespace

extern "C" void repro_matmul(const void* a, const void* b, void* c,
                             int in_type, int out_type, int batch, int m,
                             int n, int k, long long sa, long long lda,
                             long long sb, long long ldb, long long sc,
                             long long ldc, cudaStream_t stream) {
  if (in_type == REPRO_F32 && out_type == REPRO_F32)
    launch<float, float>(a, b, c, batch, m, n, k, sa, lda, sb, ldb, sc, ldc,
                         stream);
  else if (in_type == REPRO_F32 && out_type == REPRO_BF16)
    launch<float, __nv_bfloat16>(a, b, c, batch, m, n, k, sa, lda, sb, ldb,
                                 sc, ldc, stream);
  else if (in_type == REPRO_BF16 && out_type == REPRO_F32)
    launch<__nv_bfloat16, float>(a, b, c, batch, m, n, k, sa, lda, sb, ldb,
                                 sc, ldc, stream);
  else
    launch<__nv_bfloat16, __nv_bfloat16>(a, b, c, batch, m, n, k, sa, lda,
                                         sb, ldb, sc, ldc, stream);
}
