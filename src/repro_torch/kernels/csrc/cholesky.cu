// K3: Cholesky factor of one SPD block, L L^T = A (nb x nb, fp32).
//
// Replaces the reference package's Pallas kernel
// (src/repro/kernels/cholesky/cholesky.py, cholesky_block_pallas): nb steps
// of square-root pivot, column scale and rank-1 update of the trailing
// matrix in fp32, then the upper triangle zeroed.  The blocked wrapper
// (kernels/cholesky/ops.py) sends panel solves to K2 and trailing updates
// to K1, so this kernel only ever factors a diagonal block.
//
// What bounds it: nb^3/3 operations on 2*nb^2 elements (at nb = 256 about
// 5.6 Mflop on 512 KB), so the bound is bytes -- a fraction of a
// microsecond -- while a simple kernel is limited by the nb dependent steps
// and the barriers between them.
//
// What the design does about it: one CTA of 1024 threads per block
// (batched blocks on blockIdx.z run side by side).  The TPU kernel keeps
// the whole nb x nb block in VMEM; here a full 256 x 256 fp32 block (256 KB)
// does not fit the 227 KB a CTA can have, so the kernel keeps only the
// packed lower triangle (nb(nb+1)/2 words, 129 KB at nb = 256) in shared
// memory, and works in place in L (global memory, held in L2) when even the
// triangle does not fit (nb > 336).  Each step is two phases with a barrier
// after each: (1) every thread reads the pivot, the column below it is
// scaled and copied to a shared vector; (2) the trailing lower triangle is
// updated from that vector, one warp per row segment so a warp's 32 lanes
// touch 32 consecutive words.  The diagonal element of step k is kept in a
// separate vector, so no thread overwrites the pivot while others read it.
// Not yet used: a blocked (left-looking, tensor-core) factor of the block
// -- later work.
#include <cuda_runtime.h>

#include "kernels.h"

namespace {

constexpr int TX = 32;
constexpr int TY = 32;
constexpr int THREADS = TX * TY;
// largest nb whose packed triangle plus two nb-vectors fit 227 KB
constexpr int PACKED_MAX = 336;

template <bool PACKED>
__global__ void __launch_bounds__(THREADS)
    cholesky_block_kernel(const float* __restrict__ A, float* __restrict__ L,
                          int nb, long long sa, long long lda, long long sl,
                          long long ldl) {
  extern __shared__ float smem[];
  float* col = smem;        // scaled column of the current step
  float* diag = smem + nb;  // L[k][k], kept apart from the pivot
  float* tri = smem + 2 * nb;
  const long long z = blockIdx.z;
  A += z * sa;
  L += z * sl;
  const int tid = threadIdx.y * TX + threadIdx.x;
  auto at = [&](int i, int j) -> float& {
    return PACKED ? tri[i * (i + 1) / 2 + j] : L[i * ldl + j];
  };

  for (int i = threadIdx.y; i < nb; i += TY)
    for (int j = threadIdx.x; j <= i; j += TX) at(i, j) = A[i * lda + j];
  __syncthreads();

  for (int k = 0; k < nb; ++k) {
    const float d = sqrtf(at(k, k));
    for (int i = k + tid; i < nb; i += THREADS) {
      const float v = at(i, k) / d;
      col[i] = v;
      if (i == k)
        diag[k] = v;
      else
        at(i, k) = v;
    }
    __syncthreads();
    for (int i = k + 1 + threadIdx.y; i < nb; i += TY) {
      const float li = col[i];
      for (int j = k + 1 + threadIdx.x; j <= i; j += TX)
        at(i, j) = fmaf(-li, col[j], at(i, j));
    }
    __syncthreads();
  }

  for (int i = threadIdx.y; i < nb; i += TY)
    for (int j = threadIdx.x; j < nb; j += TX)
      L[i * ldl + j] = j < i ? at(i, j) : (j == i ? diag[i] : 0.f);
}

}  // namespace

extern "C" void repro_cholesky_block(const float* a, float* l, int batch,
                                     int nb, long long sa, long long lda,
                                     long long sl, long long ldl,
                                     cudaStream_t stream) {
  const dim3 grid(1, 1, batch);
  const dim3 block(TX, TY);
  if (nb <= PACKED_MAX) {
    const size_t smem = sizeof(float) * (2 * nb + nb * (nb + 1) / 2);
    cudaFuncSetAttribute(cholesky_block_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    cholesky_block_kernel<true>
        <<<grid, block, smem, stream>>>(a, l, nb, sa, lda, sl, ldl);
  } else {
    const size_t smem = sizeof(float) * 2 * nb;
    cholesky_block_kernel<false>
        <<<grid, block, smem, stream>>>(a, l, nb, sa, lda, sl, ldl);
  }
}
