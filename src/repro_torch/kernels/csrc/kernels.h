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

// The body a matmul launch ran: fp32 inputs' FFMA body, bf16 inputs'
// tensor-core body.
enum { REPRO_K1_F32 = 0, REPRO_K1_BF16_TC = 1 };

// K1: C[z] = A[z] @ B[z] with A (m, k), B (k, n), C (m, n), row-major with
// row strides lda/ldb/ldc; fp32 accumulation, C written in out_type.  fp32
// inputs run the FFMA body fed through a ring in shared memory (TMA boxes
// when A's and B's rows are 16-byte aligned, 4-byte cp.async otherwise) at
// the CTA tile tile_m x tile_n, one of the compiled configurations (64x64,
// 64x128, 128x64, 128x128, 256x64, 256x128).  bf16 inputs take the tile
// 128x128 alone (no plan reaches them) and run the tensor-core body (wgmma
// on TMA tiles of 128 x 256), which needs A's and B's starts 16-byte
// aligned and their row and batch strides multiples of 8 elements (the
// wrapper stages operands that are not).  On success *body is the body
// that ran (REPRO_K1_F32 or REPRO_K1_BF16_TC).  Returns
// cudaErrorInvalidValue, and launches nothing, for an unknown type code, m,
// n or batch below 1, k below 0 (below 1 for bf16), batch above 65535, a
// tile that is not compiled for the input type or more than INT_MAX tiles;
// cudaErrorMisalignedAddress for bf16 operands TMA cannot load; and the
// error of raising a body's shared-memory limit if that fails.
cudaError_t repro_matmul(const void* a, const void* b, void* c, int in_type,
                         int out_type, int batch, int m, int n, int k,
                         long long sa, long long lda, long long sb,
                         long long ldb, long long sc, long long ldc,
                         int tile_m, int tile_n, int* body,
                         cudaStream_t stream);

// K1's fp32 body (TMA path, fp32 output) at CTA tile tile_m x tile_n as
// loaded on the current device: out[0..6] = registers a thread, local
// (spill) bytes a thread, static and dynamic shared memory a CTA in bytes,
// resident CTAs an SM, threads a CTA and the ring's stages.  Returns
// cudaErrorInvalidValue, and writes nothing, for a tile not compiled.
cudaError_t repro_matmul_info(int tile_m, int tile_n, long long* out);

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

// The body a K4 launch ran (repro_flash_attention's *body): bf16 on the
// tensor cores, up to d = 256 or wide; fp32 FFMA at one tile of its
// template, <query rows a CTA>x<rows a thread>x<chunks of O's columns>.
enum {
  REPRO_K4_BF16_TC = 0,
  REPRO_K4_BF16_TC_WIDE = 1,
  REPRO_K4_F32_128X8X1 = 2,
  REPRO_K4_F32_64X8X1 = 3,
  REPRO_K4_F32_64X4X4 = 4,
  REPRO_K4_F32_32X4X3 = 5
};

// K4: o[b, h] = softmax(q[b, h] k[b, h / (H / KV)]^T * scale) v[b, h / (H /
// KV)], causal or not, with q, o (batch, heads, sq, d) and k, v (batch,
// kv_heads, skv, d) addressed by element strides, 12 of them in the order
// (batch, head, row) for q, k, v, o; unit stride along d. The type
// (REPRO_F32 or REPRO_BF16) is that of all four: fp32 runs on the CUDA
// cores (IEEE FFMA, O in registers, cp.async stages) at a tile the launcher
// picks from d and the grid, bf16 on the tensor cores with TMA loads, above
// d = 256 in its wide body (O's columns in slices of 256 a CTA). On success
// *body is the body that ran (REPRO_K4_*). Launches nothing and returns
// cudaErrorInvalidValue unless d is 64, 96, 128, 256 or a multiple of 64 up
// to repro_flash_attention_max_head_dim(), and cudaErrorMisalignedAddress
// for operands the loads cannot take: q, k and v (fp32: and o) must be
// 16-byte aligned with strides in multiples of 16 bytes.
cudaError_t repro_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, int dtype, int batch, int heads,
                                  int kv_heads, int sq, int skv, int d,
                                  const long long* strides, float scale,
                                  int causal, int* body, cudaStream_t stream);

// K4's widest head dim above 256: the largest multiple of 64, up to 768,
// whose tiles fit the current device's opt-in shared memory of a block in
// both wide bodies (the bf16 body's resident 128-row query tile beside a
// ring of at least 4 panels; the fp32 body's query tile, stages and P);
// 0 when the device cannot be read.
int repro_flash_attention_max_head_dim(void);

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
// reference runs it as a scan over time), as a scan over chunks of `chunk`
// steps: three launches (chunk summaries, the carry, the outputs) through
// `work`, an fp32 workspace of repro_slstm_scan_workspace() floats that the
// caller allocates on the device.  c, n and m, all null or all of y's
// shape, take the state after every step (for the backward).  Returns
// cudaErrorInvalidValue, and launches nothing, unless every size is
// positive, the chunks number at most 65535 and c, n, m are all given or
// all null; cudaErrorInvalidDevicePointer for a workspace of fewer floats.
long long repro_slstm_scan_workspace(int batch, int s, int w, int chunk);
cudaError_t repro_slstm_scan(const float* z, const float* i, const float* f,
                             const float* o, float* y, float* c, float* n,
                             float* m, float* work, long long work_floats,
                             int batch, int s, int w, int chunk,
                             cudaStream_t stream);
// K6's backward: from the inputs, the per-step state c, n, m of the
// forward and dy, all (batch, s, w) fp32 and contiguous, the gradients dz,
// di, df, d_o of the same shape, as a reverse scan over chunks of `chunk`
// steps: three launches (chunk maps, the carry, the outputs) through
// `work`, an fp32 workspace of repro_slstm_scan_bwd_workspace() floats
// that the caller allocates on the device.  Returns cudaErrorInvalidValue,
// and launches nothing, unless every size is positive and the chunks
// number at most 65535; cudaErrorInvalidDevicePointer for a workspace of
// fewer floats.
long long repro_slstm_scan_bwd_workspace(int batch, int s, int w, int chunk);
cudaError_t repro_slstm_scan_bwd(const float* z, const float* i,
                                 const float* f, const float* o,
                                 const float* c, const float* n,
                                 const float* m, const float* dy, float* dz,
                                 float* di, float* df, float* d_o,
                                 float* work, long long work_floats,
                                 int batch, int s, int w, int chunk,
                                 cudaStream_t stream);

#ifdef __cplusplus
}
#endif
