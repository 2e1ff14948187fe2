// Plain C interface of the port's CUDA kernels (K1-K3).
//
// Every launcher takes device pointers, element strides and the CUDA stream
// the caller (PyTorch's current stream) wants the work on.  A launcher only
// enqueues: it allocates nothing, does not synchronise and leaves the launch
// status for the caller to check with cudaGetLastError().  Leading batch
// dimensions (the stacked ranks of a process grid) run on blockIdx.z; a
// batch stride of 0 shares one operand across the batch.
#pragma once

#include <cuda_runtime.h>

#ifdef __cplusplus
extern "C" {
#endif

// Element type codes of the matmul launcher.
enum { REPRO_F32 = 0, REPRO_BF16 = 1 };

// K1: C[z] = A[z] @ B[z] with A (m, k), B (k, n), C (m, n), row-major with
// row strides lda/ldb/ldc; fp32 accumulation, C written in out_type.
void repro_matmul(const void* a, const void* b, void* c, int in_type,
                  int out_type, int batch, int m, int n, int k,
                  long long sa, long long lda, long long sb, long long ldb,
                  long long sc, long long ldc, cudaStream_t stream);

// K2: X[z] U[z] = B[z] for one upper-triangular diagonal block U (nb, nb);
// B and X are (m, nb); fp32.
void repro_trsm_diag(const float* u, const float* b, float* x, int batch,
                     int m, int nb, long long su, long long ldu, long long sb,
                     long long ldb, long long sx, long long ldx,
                     cudaStream_t stream);

// K3: L[z] L[z]^T = A[z] for one SPD block (nb, nb); L is lower-triangular
// with its upper triangle written as zeros; fp32.
void repro_cholesky_block(const float* a, float* l, int batch, int nb,
                          long long sa, long long lda, long long sl,
                          long long ldl, cudaStream_t stream);

#ifdef __cplusplus
}
#endif
