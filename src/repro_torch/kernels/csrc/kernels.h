// Plain C interface of the port's CUDA kernels (K1-K6).
//
// Every launcher takes device pointers, element strides and the CUDA stream
// the caller (PyTorch's current stream) wants the work on.  A launcher only
// enqueues: it allocates nothing, does not synchronise and leaves the launch
// status for the caller to check with cudaGetLastError() (each also returns
// what it refused, or what failed, before launching).  Leading batch
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
// row strides lda/ldb/ldc; fp32 accumulation, C written in out_type.  fp32
// inputs run the FFMA body fed through a ring in shared memory (TMA boxes
// when A's and B's rows are 16-byte aligned, 4-byte cp.async otherwise),
// bf16 inputs the earlier body.  Returns cudaErrorInvalidValue, and
// launches nothing, for an unknown type code, m, n or batch below 1, k below
// 0, batch above 65535 or more than INT_MAX tiles of 128 x 128; and the
// error of raising the fp32 body's shared-memory limit if that fails.
cudaError_t repro_matmul(const void* a, const void* b, void* c, int in_type,
                         int out_type, int batch, int m, int n, int k,
                         long long sa, long long lda, long long sb,
                         long long ldb, long long sc, long long ldc,
                         cudaStream_t stream);

// K1's fp32 body (TMA path, fp32 output) as loaded on the current
// device: out[0..4] = registers a thread, local (spill) bytes a thread,
// static and dynamic shared memory a CTA in bytes, and resident CTAs an SM.
cudaError_t repro_matmul_info(long long* out);

// K2: X[z] U[z] = B[z] for one upper-triangular diagonal block U (nb, nb);
// B and X are (m, nb); fp32.  Returns cudaErrorInvalidValue, and launches
// nothing, unless m and nb are positive.
cudaError_t repro_trsm_diag(const float* u, const float* b, float* x,
                            int batch, int m, int nb, long long su,
                            long long ldu, long long sb, long long ldb,
                            long long sx, long long ldx, cudaStream_t stream);

// K3: L[z] L[z]^T = A[z] for one SPD block (nb, nb); L is lower-triangular
// with its upper triangle written as zeros; fp32.  Returns
// cudaErrorInvalidValue, and launches nothing, unless 1 <= nb <= 336 (the
// widest block one CTA holds; the wrapper composes wider ones), and the
// error of raising the CTA's shared-memory limit if that fails.
cudaError_t repro_cholesky_block(const float* a, float* l, int batch,
                                 int nb, long long sa, long long lda,
                                 long long sl, long long ldl,
                                 cudaStream_t stream);

// K4: o[b, h] = softmax(q[b, h] k[b, h / (H / KV)]^T * scale) v[b, h / (H /
// KV)], causal or not, with q, o (batch, heads, sq, d) and k, v (batch,
// kv_heads, skv, d) addressed by element strides, 12 of them in the order
// (batch, head, row) for q, k, v, o; unit stride along d. The type
// (REPRO_F32 or REPRO_BF16) is that of all four: fp32 runs on the CUDA
// cores, bf16 on the tensor cores with TMA loads. Launches nothing and
// returns cudaErrorInvalidValue unless d is 64, 96 or 128, and
// cudaErrorMisalignedAddress for bf16 operands that TMA cannot load (q, k
// and v 16-byte aligned, their strides multiples of 8 elements).
cudaError_t repro_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, int dtype, int batch, int heads,
                                  int kv_heads, int sq, int skv, int d,
                                  const long long* strides, float scale,
                                  int causal, cudaStream_t stream);

// K5: y[b, h] = the decayed linear attention of q, k (s, dk), v (s, dv) and
// log_a (s,) <= 0 (fp32), addressed by element strides, 15 of them in the
// order (batch, head, row) for q, k, v, log_a, y; unit stride along dk and
// dv. q, k, v and y share the type (REPRO_F32 or REPRO_BF16). Three
// launches (chunk states, the state pass, the outputs) through `work`, an
// fp32 workspace of repro_ssm_scan_workspace() floats that the caller
// allocates on the device. Returns cudaErrorInvalidValue, and launches
// nothing, unless every size is positive and dk <= 256 (the widest a tile
// holds), and cudaErrorInvalidDevicePointer for a workspace of fewer floats.
long long repro_ssm_scan_workspace(int batch, int heads, int s, int dk,
                                   int dv);
cudaError_t repro_ssm_scan(const void* q, const void* k, const void* v,
                           const float* log_a, void* y, float* work,
                           long long work_floats, int dtype, int batch,
                           int heads, int s, int dk, int dv,
                           const long long* strides, cudaStream_t stream);

// K6: the sLSTM recurrence, per feature of z, i, f, o (batch, s, w), fp32
// and contiguous, into y of the same shape (a port-side kernel; the
// reference runs it as a scan over time). Returns cudaErrorInvalidValue, and
// launches nothing, unless every size is positive.
cudaError_t repro_slstm_scan(const float* z, const float* i, const float* f,
                             const float* o, float* y, int batch, int s,
                             int w, cudaStream_t stream);

#ifdef __cplusplus
}
#endif
