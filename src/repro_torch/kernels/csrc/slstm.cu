// K6: the sLSTM recurrence (xLSTM's scalar-memory cell) on the CUDA cores,
// IEEE fp32.
//
// A port-side kernel: the reference package has no Pallas kernel for it.
// It runs the time loop of src/repro/models/ssm.py (slstm_train, a scan of
// _slstm_step over the sequence) on the device, where the plain PyTorch
// loop would issue about a dozen elementwise launches a step from the host.
// Per feature, with the gates' pre-activations z, i, f, o (B, S, W) and
// c = n = m = 0 at t = 0:
//   log_f = log_sigmoid(f) = -softplus(-f)
//   m'    = max(log_f + m, i)
//   c'    = exp(log_f + m - m') c + exp(i - m') tanh(z)
//   n'    = exp(log_f + m - m') n + exp(i - m')
//   y     = sigmoid(o) c' / max(n', 1)
// The exponentials, log1p and tanh are expf, log1pf and tanhf, not the
// fast intrinsics (__expf and friends), and the division is IEEE: the
// stabiliser m keeps the exponents <= 0, but with |i| near 30 the fast
// versions' relative error would show in c and n.
//
// What bounds it: no weight is applied inside the loop, so it reads z, i,
// f, o once and writes y once: at xlstm's shape (B 4, S 4096, W 1024) 5 x
// 67 MB, 0.10 ms at the memory rate.  The features are independent and
// the steps of one feature are a chain.
//
// What the design does about it: one thread a (batch row, feature), the
// state (c, n, m) in registers, the loop over t inside the thread.  A warp
// covers 32 neighbouring features, so every load and store is one
// coalesced 128-byte line.  The thread loads STEPS steps of its four
// inputs before it computes them, so that 4 x STEPS loads are in flight
// while the chain waits.  At xlstm's shape that is B x W = 4096 threads,
// one warp a CTA on 128 CTAs: the loads' latency, not the bytes, bounds
// it.  Not yet used: streaming the next steps' inputs while computing
// these, and a scan over time (m is a max-plus scan, c and n are linear
// once m is known).
#include <cuda_runtime.h>
#include <limits.h>

#include "kernels.h"

namespace {

constexpr int THREADS = 32;     // one warp a CTA: 32 features
constexpr int STEPS = 8;        // steps loaded ahead of their computation

__device__ __forceinline__ float log_sigmoid(float x) {
  // -softplus(-x), softplus(u) = max(u, 0) + log1p(exp(-|u|))
  return -(fmaxf(-x, 0.f) + log1pf(expf(-fabsf(x))));
}

__global__ void __launch_bounds__(THREADS)
slstm_scan_kernel(const float* __restrict__ z, const float* __restrict__ gi,
                  const float* __restrict__ gf, const float* __restrict__ go,
                  float* __restrict__ y, long long columns, int s, int w) {
  const long long col = static_cast<long long>(blockIdx.x) * THREADS +
                        threadIdx.x;
  if (col >= columns) return;
  const long long row = col / w;
  const long long base = row * s * static_cast<long long>(w) + col % w;
  float c = 0.f, n = 0.f, m = 0.f;   // m starts at 0, as the reference's
  for (int t0 = 0; t0 < s; t0 += STEPS) {
    float zr[STEPS], ir[STEPS], fr[STEPS], orr[STEPS];
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      if (t0 + u < s) {
        const long long at = base + static_cast<long long>(t0 + u) * w;
        zr[u] = z[at];
        ir[u] = gi[at];
        fr[u] = gf[at];
        orr[u] = go[at];
      }
    }
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      if (t0 + u < s) {
        const float log_f = log_sigmoid(fr[u]);
        const float m_new = fmaxf(log_f + m, ir[u]);
        const float i_st = expf(ir[u] - m_new);
        const float f_st = expf(log_f + m - m_new);
        c = f_st * c + i_st * tanhf(zr[u]);
        n = f_st * n + i_st;
        const float gate = 1.f / (1.f + expf(-orr[u]));
        y[base + static_cast<long long>(t0 + u) * w] =
            gate * c / fmaxf(n, 1.f);
        m = m_new;
      }
    }
  }
}

}  // namespace

extern "C" cudaError_t repro_slstm_scan(const float* z, const float* i,
                                        const float* f, const float* o,
                                        float* y, int batch, int s, int w,
                                        cudaStream_t stream) {
  if (batch < 1 || s < 1 || w < 1) return cudaErrorInvalidValue;
  const long long columns = static_cast<long long>(batch) * w;
  const long long blocks = (columns + THREADS - 1) / THREADS;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  slstm_scan_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      z, i, f, o, y, columns, s, w);
  return cudaSuccess;
}
