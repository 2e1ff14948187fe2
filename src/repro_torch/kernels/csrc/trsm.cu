// K2: diagonal-block triangular solve X U = B (U upper-triangular, nb x nb).
//
// Replaces the reference package's Pallas kernel
// (src/repro/kernels/trsm/trsm.py, trsm_diag_pallas): the column recurrence
// x_k = (b_k - X[:, :k] U[:k, k]) / U[k, k] in fp32, every row of B
// independent.  The blocked wrapper (kernels/trsm/ops.py) sends all the
// off-diagonal O(n^3) work to K1, so this kernel only ever sees one
// diagonal block.
//
// What bounds it: per launch m*nb^2 operations on m*nb*2 + nb^2 elements --
// bound by operations at the main path's shapes (m = 16128, nb = 256), but
// what really limits a simple kernel is the recurrence: nb dependent column
// steps.
//
// What the design does about it: the TPU kernel holds the whole (nb, nb)
// block of U and a (256, nb) block of B in VMEM.  At nb = 256 that is
// 512 KB, more than the 227 KB a CTA can have, and the block width is the
// plan's algorithmic choice, so it is honoured, not shrunk.  Instead each
// CTA owns a strip of 32 rows of B (32 x nb fp32 in shared memory, 33 KB at
// nb = 256) and reads U through L1/L2, where every warp shares each U row.
// The solve is right-looking: at step k every thread divides its row's
// b_k by U[k, k] and subtracts x_k U[k, j] from its share of the columns
// j > k (8 threads per row, columns interleaved so that all 8 stay busy).
// Rows never interact, and a row's 8 threads sit in one warp, so a step
// ends with __syncwarp() and no block-wide barrier.  Column k is only read
// at step k, so the final x_k = b_k / U[k, k] is taken when the strip is
// written out.  Not yet used: register-resident strips or tensor-core
// updates of column panels -- later work.
#include <cuda_runtime.h>

#include "kernels.h"

namespace {

constexpr int ROWS = 32;             // rows of B per CTA
constexpr int TPR = 8;               // threads per row, one warp = 4 rows
constexpr int THREADS = ROWS * TPR;  // 256

__global__ void __launch_bounds__(THREADS)
    trsm_diag_kernel(const float* __restrict__ U, const float* __restrict__ B,
                     float* __restrict__ X, int M, int nb, int lds,
                     long long su, long long ldu, long long sb, long long ldb,
                     long long sx, long long ldx) {
  extern __shared__ float strip[];  // ROWS x lds
  const long long z = blockIdx.z;
  U += z * su;
  B += z * sb;
  X += z * sx;
  const int r = threadIdx.x / TPR;
  const int t = threadIdx.x % TPR;
  const int row = blockIdx.x * ROWS + r;
  const bool live = row < M;
  float* s = strip + r * lds;

  for (int j = t; j < nb; j += TPR) s[j] = live ? B[row * ldb + j] : 0.f;
  __syncwarp();
  for (int k = 0; k < nb; ++k) {
    const float xk = s[k] / __ldg(&U[k * ldu + k]);
    const float* urow = U + k * ldu;
    // first column > k that is this thread's (j = t mod TPR)
    for (int j = k + 1 + ((t - k - 1) & (TPR - 1)); j < nb; j += TPR)
      s[j] = fmaf(-xk, __ldg(&urow[j]), s[j]);
    __syncwarp();
  }
  if (live)
    for (int j = t; j < nb; j += TPR)
      X[row * ldx + j] = s[j] / __ldg(&U[j * ldu + j]);
}

}  // namespace

extern "C" void repro_trsm_diag(const float* u, const float* b, float* x,
                                int batch, int m, int nb, long long su,
                                long long ldu, long long sb, long long ldb,
                                long long sx, long long ldx,
                                cudaStream_t stream) {
  // pad the strip's row stride by 8 words so the 4 rows of a warp fall in
  // disjoint banks
  const int lds = (nb + 31) / 32 * 32 + 8;
  const size_t smem = sizeof(float) * ROWS * lds;
  cudaFuncSetAttribute(trsm_diag_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const dim3 grid((m + ROWS - 1) / ROWS, 1, batch);
  trsm_diag_kernel<<<grid, THREADS, smem, stream>>>(u, b, x, m, nb, lds, su,
                                                    ldu, sb, ldb, sx, ldx);
}
