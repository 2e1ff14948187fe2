// K5: chunked decayed linear attention (the SSD / mLSTM scan) on the CUDA
// cores (fp32 FFMA).
//
// Replaces the reference package's Pallas scan
// (src/repro/kernels/ssm_scan/ssm_scan.py, ssm_scan_pallas): per head, the
// recurrence S_t = a_t S_{t-1} + k_t v_t^T, y_t = q_t . S_t, computed in
// chunk-parallel form with a DK x DV fp32 state carried over the chunks in
// order and every exponent <= 0: exp(A_i - A_j) for j <= i within a chunk,
// exp(A_i) and exp(total) on the carried state, exp(total - A_j) on the
// state update, A being the inclusive running sum of log a.
//
// What bounds it: at hymba's shapes (DK = 16, DV = 64, S = 4096) a head
// does about C * (DK + DV) + 2 DK DV operations per row for a chunk of C and
// reads 2 DK + DV + 1 values per row, so it sits near the card's
// operations-per-byte balance; but the chunks of a head are sequential and
// B * H = 100 heads give only 100 CTAs for 132 SMs, so what bounds it in
// practice is the latency of one CTA's chain of chunks, not the card's
// rates.
//
// What the design does about it: one CTA of 256 threads per (batch, head)
// walks the sequence in chunks of 64 (the TPU plan's bs is a VMEM choice
// and sets nothing here). The state stays in shared memory for the whole
// walk; each chunk's q, k, v rows, its 64 x 64 decayed scores and its
// running sums are staged there too (q and k rows padded by one so that
// the score loop reads 32 distinct banks). Each phase -- scores, outputs
// (with the state before the chunk), the decayed keys, the state update --
// is spread over all 256 threads, one barrier between phases. The shared
// memory needed grows with DK x DV; the launcher refuses a state that does
// not fit a block (xlstm's 256 x 257) instead of running wrong. The tail of the
// last chunk is zero-filled with log a = 0, which is what the reference's
// zero padding computes. Inputs are addressed by (batch, head, row)
// strides: the heads split out of the projections need no copy.
// Not yet used: splitting a head's chunks over CTAs (a second pass over the
// chunk states) to fill the card, and the tensor cores -- later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "kernels.h"

namespace {

constexpr int C = 64;           // chunk rows
constexpr int THREADS = 256;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    ssm_scan_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ la,
                    T* __restrict__ y, int H, int s, int dk, int dv,
                    long long qsb, long long qsh, long long qss, long long ksb,
                    long long ksh, long long kss, long long vsb,
                    long long vsh, long long vss, long long lsb,
                    long long lsh, long long lss, long long ysb,
                    long long ysh, long long yss) {
  extern __shared__ __align__(16) float smem[];
  const int ldk = dk + 1;
  float* St = smem;                 // [dk][dv] the carried state
  float* qs = St + dk * dv;         // [C][ldk]
  float* ks = qs + C * ldk;         // [C][ldk], decayed for the update
  float* vs = ks + C * ldk;         // [C][dv]
  float* sc = vs + C * dv;          // [C][C] decayed scores, j <= i
  float* A = sc + C * C;            // [C] inclusive running sum of log a

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  q += b * qsb + h * qsh;
  k += b * ksb + h * ksh;
  v += b * vsb + h * vsh;
  la += b * lsb + h * lsh;
  y += b * ysb + h * ysh;
  const int tid = threadIdx.x;

  for (int e = tid; e < dk * dv; e += THREADS) St[e] = 0.f;

  for (int c0 = 0; c0 < s; c0 += C) {
    __syncthreads();   // the last chunk's state update is done
    for (int e = tid; e < C * dk; e += THREADS) {
      const int i = e / dk;
      const int d = e % dk;
      const int t = c0 + i;
      qs[i * ldk + d] = t < s ? widen(q[t * qss + d]) : 0.f;
      ks[i * ldk + d] = t < s ? widen(k[t * kss + d]) : 0.f;
    }
    for (int e = tid; e < C * dv; e += THREADS) {
      const int i = e / dv;
      const int c = e % dv;
      const int t = c0 + i;
      vs[e] = t < s ? widen(v[t * vss + c]) : 0.f;
    }
    if (tid < 32) {
      // inclusive running sum over the chunk: two values a lane, then a
      // warp scan of the lane totals
      const int t0 = c0 + 2 * tid;
      const float a0 = t0 < s ? la[t0 * lss] : 0.f;
      const float a1 = t0 + 1 < s ? la[(t0 + 1) * lss] : 0.f;
      float run = a0 + a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float x = __shfl_up_sync(0xffffffffu, run, off);
        if (tid >= off) run += x;
      }
      A[2 * tid + 1] = run;
      A[2 * tid] = run - a1;
    }
    __syncthreads();

    // intra-chunk scores: (q_i . k_j) exp(A_i - A_j) for j <= i, else 0
    for (int e = tid; e < C * C; e += THREADS) {
      const int i = e / C;
      const int j = e % C;
      float val = 0.f;
      if (j <= i) {
        float dot = 0.f;
        for (int d = 0; d < dk; ++d)
          dot = fmaf(qs[i * ldk + d], ks[j * ldk + d], dot);
        val = dot * expf(A[i] - A[j]);
      }
      sc[e] = val;
    }
    __syncthreads();

    // outputs: the intra-chunk sum plus (q_i exp(A_i)) . S_prev
    for (int e = tid; e < C * dv; e += THREADS) {
      const int i = e / dv;
      const int c = e % dv;
      if (c0 + i >= s) continue;
      float intra = 0.f;
      for (int j = 0; j <= i; ++j)
        intra = fmaf(sc[i * C + j], vs[j * dv + c], intra);
      float inter = 0.f;
      for (int d = 0; d < dk; ++d)
        inter = fmaf(qs[i * ldk + d], St[d * dv + c], inter);
      put(&y[(c0 + i) * yss + c], intra + inter * expf(A[i]));
    }
    // keys decayed to the chunk's end, for the state update
    const float total = A[C - 1];
    for (int e = tid; e < C * dk; e += THREADS) {
      const int j = e / dk;
      const int d = e % dk;
      ks[j * ldk + d] *= expf(total - A[j]);
    }
    __syncthreads();

    // S <- exp(total) S + sum_j (k_j exp(total - A_j)) v_j^T
    const float decay = expf(total);
    for (int e = tid; e < dk * dv; e += THREADS) {
      const int d = e / dv;
      const int c = e % dv;
      float upd = 0.f;
      for (int j = 0; j < C; ++j)
        upd = fmaf(ks[j * ldk + d], vs[j * dv + c], upd);
      St[e] = St[e] * decay + upd;
    }
  }
}

// the layout above
size_t smem_bytes(int dk, int dv) {
  return sizeof(float) *
         (static_cast<size_t>(dk) * dv + 2 * C * (dk + 1) + C * dv + C * C +
          C);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* log_a, void* y, int batch, int heads, int s,
                   int dk, int dv, const long long* st, size_t smem,
                   cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      ssm_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ssm_scan_kernel<T><<<batch * heads, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), log_a, static_cast<T*>(y), heads, s, dk, dv,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], st[12], st[13], st[14]);
  return cudaSuccess;
}

}  // namespace

extern "C" cudaError_t repro_ssm_scan(const void* q, const void* k,
                                      const void* v, const float* log_a,
                                      void* y, int dtype, int batch,
                                      int heads, int s, int dk, int dv,
                                      const long long* st,
                                      cudaStream_t stream) {
  const size_t smem = smem_bytes(dk, dv);
  int device = 0;
  int limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(limit)) return cudaErrorInvalidValue;
  if (dtype == REPRO_BF16)
    return launch<__nv_bfloat16>(q, k, v, log_a, y, batch, heads, s, dk, dv,
                                 st, smem, stream);
  return launch<float>(q, k, v, log_a, y, batch, heads, s, dk, dv, st, smem,
                       stream);
}
