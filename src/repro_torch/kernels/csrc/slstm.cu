// K6: the sLSTM recurrence (xLSTM's scalar-memory cell) on the CUDA cores,
// IEEE fp32, as a chunked scan over time; and its backward.
//
// A port-side kernel: the reference package has no Pallas kernel for it.
// It runs the time loop of src/repro/models/ssm.py (slstm_train, a
// lax.scan of _slstm_step over the sequence) on the device, where the
// plain PyTorch loop would issue about a dozen elementwise launches a step
// from the host.  Per feature, with the gates' pre-activations z, i, f, o
// (B, S, W) and c = n = m = 0 at t = 0:
//   lf = log_sigmoid(f) = -softplus(-f)
//   a  = lf + m
//   m' = max(a, i)
//   c' = exp(a - m') c + exp(i - m') tanh(z)
//   n' = exp(a - m') n + exp(i - m')
//   y  = sigmoid(o) c' / max(n', 1)
// The exponentials, log1p and tanh are expf, log1pf and tanhf, not the
// fast intrinsics (__expf and friends), and the division is IEEE: the
// stabiliser m keeps the exponents <= 0, but with |i| near 30 the fast
// versions' relative error would show in c and n.
//
// What bounds it: no weight is applied inside the loop, so the function
// reads z, i, f, o once and writes y once: at xlstm's shape (B 4, S 4096,
// W 1024) 5 x 67 MB, 0.10 ms at the memory rate.  The features are
// independent; the steps of one feature are a chain.
//
// What the design does about it.  The recurrence is a max-plus scan in m
// and, once m is known, linear in c and n, so a chunk of L steps has an
// exact summary: LF, the sum of lf over the chunk, and (C, N, M), the
// chunk's own state from c = n = 0, m = -inf.  From the state (c, n, m) at
// the chunk's start, its end state is
//   m_end = max(m + LF, M)
//   c_end = c exp(m + LF - m_end) + C exp(M - m_end)
//   n_end = n exp(m + LF - m_end) + N exp(M - m_end)
// with every exponent <= 0.  Three launches, as K5 (ssm_scan.cu):
//   1. slstm_chunk_kernel: one thread a (feature, chunk) runs its chunk
//      from the empty state and writes (LF, C, N, M) to the workspace;
//   2. slstm_carry_kernel: one thread a feature walks the S / L summaries
//      in order and writes each chunk's start state over its summary;
//   3. slstm_output_kernel: one thread a (feature, chunk) replays its
//      chunk from the carried start state, step for step as the plain
//      loop does, and writes y (and, for the backward, the per-step c, n,
//      m).
// At xlstm's prefill shape and L = 32 (the wrapper's) that is 128 x 4096
// threads a phase, where a thread a feature gave 128 one-warp CTAs on 132
// SMs.  A CTA is 128
// neighbouring features of one chunk, so every load and store of a warp is
// one coalesced 128-byte line.  Each thread stages its inputs RING steps
// ahead into a ring of its own in shared memory by 4-byte cp.async (one
// commit group a step), so that the loads of the next steps are in flight
// while this step's chain runs, and takes a GROUP of steps at a time: the
// state-free parts (log_sigmoid(f), tanh(z), sigmoid(o)) of the group go
// first, then the chain.  A thread reads only the slots it wrote, so no
// barrier is needed; a slot is refilled only after its values have been
// used.  Phases 1 and 3 read 3 and 4 inputs and phase 3 writes y: 8 x 4
// bytes a step-feature against the function's 5 x 4 (0.16 ms at xlstm's
// shape), in exchange for S / L times the parallelism.  Neither a deeper
// ring nor larger groups were faster on the card (PERF.md).
//
// The backward carries (dc, dn, dm) from t + 1 to t, from the last step to
// the first.  With c_p, n_p, m_p the saved state at t - 1 (0 at t = 0),
// th = tanh z, g = sigmoid o, d = max(n, 1), fs = exp(a - m),
// is = exp(i - m):
//   dct = dc + dy g / d
//   dnt = dn - dy g c / d^2 [n >= 1]
//   do  = dy (c / d) g (1 - g)
//   dfs = dct c_p + dnt n_p,   dis = dct th + dnt
//   dz  = dct is (1 - th^2)
//   dml = dm - (dfs fs + dis is)
//   wa  = [a > i] + 1/2 [a = i]
//   da  = dfs fs + dml wa,     di = dis is + dml (1 - wa)
//   df  = da sigmoid(-f)
//   dm <- da,  dc <- dct fs,  dn <- dnt fs
// The tie rules are autograd's (torch.maximum splits 1/2 at a tie,
// torch.clamp(min=1) passes the gradient at n = 1), as is the order of
// dis * is on the two lines where it cancels.  The function reads z, i,
// f, o, dy and the saved c, n, m and writes dz, di, df, do: 12 x 4 bytes a
// step-feature.
//
// The carry is affine in (dc, dn, dm), with coefficients from step t's
// inputs and saved state alone: with al = dy g / d and
// be = -dy g c / d^2 [n >= 1],
//   dc <- fs (dc + al),  dn <- fs (dn + be),
//   dm <- wa dm + P (dc + al) + Q (dn + be),
//   P = (1 - wa) fs c_p - wa is th,  Q = (1 - wa) fs n_p - wa is.
// So a chunk of L steps has an exact summary, composed in reverse time:
// dc_out = F dc + Oc, dn_out = F dn + On, dm_out = W dm + Pc dc + Pn dn +
// Om, seven floats (F the product of fs, W that of wa).  The map is
// triangular with diagonal factors fs <= 1 and wa in {0, 1/2, 1}, so a
// composed chunk's coefficients grow at most linearly with L.  The
// backward runs as the forward does, in three launches:
//   1. slstm_bwd_chunk_kernel: one thread a (feature, chunk) composes its
//      chunk's map from its last step to its first into the workspace;
//   2. slstm_bwd_carry_kernel: one thread a feature walks the maps from
//      the last chunk to the first and writes each chunk's incoming
//      (dc, dn, dm) over its map;
//   3. slstm_bwd_output_kernel: one thread a (feature, chunk) replays its
//      chunk from the carried (dc, dn, dm), step for step as the plain
//      loop does, and writes dz, di, df and do.
// Phases 1 and 3 stage z, i, f, o, dy at t and c, n, m at t - 1 RING_BWD
// steps ahead by 4-byte cp.async, as the forward does, and carry c, n, m
// at t from the step before: 8 x 4 bytes a step-feature each, and phase 3
// writes 4 x 4: 20 x 4 bytes against the function's 12 x 4, in exchange
// for S / L times the parallelism of one reverse chain a feature.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "kernels.h"

namespace {

constexpr int THREADS = 128;      // features a CTA, every phase
constexpr int RING = 8;           // steps staged ahead, phases 1 and 3
constexpr int RING_BWD = 8;       // steps staged ahead, backward 1 and 3
constexpr int NIN_BWD = 8;        // z, i, f, o, dy at t; c, n, m at t - 1
constexpr int GROUP = 4;          // steps taken at a time
constexpr int MAX_CHUNKS = 65535; // gridDim.y

static_assert(RING % GROUP == 0 && RING_BWD % GROUP == 0,
              "a ring holds whole groups");

__device__ __forceinline__ float log_sigmoid(float x) {
  // -softplus(-x), softplus(u) = max(u, 0) + log1p(exp(-|u|))
  return -(fmaxf(-x, 0.f) + log1pf(expf(-fabsf(x))));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// 4-byte cp.async of src into dst; zero-fills when !valid (src is then
// not read, but must be a valid address).  No barrier orders a thread's
// ring for the compiler, so these three are memory clobbers: the reads of
// a slot stay after its wait and before its refill.
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           bool valid = true) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Where a (feature, chunk) thread works: its feature's column of the
// (B, S, W) inputs at the chunk's first step, the chunk's length and its
// slot in the (B, chunks, W) workspace.
struct ChunkAt {
  long long base;   // element (row, t0, feature)
  long long slot;   // float4 (row, chunk, feature)
  int len;          // steps in the chunk
};

__device__ __forceinline__ ChunkAt chunk_at(long long col, int s, int w,
                                            int chunk, int chunks) {
  const long long row = col / w;
  const long long feature = col % w;
  const int k = blockIdx.y;
  const int t0 = k * chunk;
  return {(row * s + t0) * w + feature, (row * chunks + k) * w + feature,
          min(chunk, s - t0)};
}

// Stages step u of a chunk (inputs src[0..NIN) at stride w) into its ring
// slot; past the chunk's end it copies nothing, but the group is committed
// all the same, so that every thread counts RING groups ahead.
template <int NIN>
__device__ __forceinline__ void stage(float (*ring)[NIN][THREADS],
                                      const float* const* src, int u,
                                      int len, int w) {
  if (u < len) {
    const long long at = static_cast<long long>(u) * w;
#pragma unroll
    for (int q = 0; q < NIN; ++q)
      copy_async(&ring[u % RING][q][threadIdx.x], src[q] + at);
  }
  commit();
}

// Phase 1: each (feature, chunk) from the empty state -> (LF, C, N, M).
__global__ void __launch_bounds__(THREADS)
slstm_chunk_kernel(const float* __restrict__ z, const float* __restrict__ gi,
                   const float* __restrict__ gf, float4* __restrict__ work,
                   long long columns, int s, int w, int chunk, int chunks) {
  __shared__ float ring[RING][3][THREADS];
  const long long col = static_cast<long long>(blockIdx.x) * THREADS +
                        threadIdx.x;
  if (col >= columns) return;
  const ChunkAt at = chunk_at(col, s, w, chunk, chunks);
  const float* src[3] = {z + at.base, gi + at.base, gf + at.base};
#pragma unroll
  for (int u = 0; u < RING; ++u) stage<3>(ring, src, u, at.len, w);
  float lf_sum = 0.f, c = 0.f, n = 0.f, m = -INFINITY;
  for (int u0 = 0; u0 < at.len; u0 += GROUP) {
    wait_groups<RING - GROUP>();
    float th[GROUP], ir[GROUP], lf[GROUP];
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      const int slot = (u0 + g) % RING;
      th[g] = tanhf(ring[slot][0][threadIdx.x]);
      ir[g] = ring[slot][1][threadIdx.x];
      lf[g] = log_sigmoid(ring[slot][2][threadIdx.x]);
    }
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      if (u0 + g < at.len) {
        lf_sum += lf[g];
        const float a = lf[g] + m;
        const float m_new = fmaxf(a, ir[g]);
        const float i_st = expf(ir[g] - m_new);
        const float f_st = expf(a - m_new);   // 0 at the first step
        c = f_st * c + i_st * th[g];
        n = f_st * n + i_st;
        m = m_new;
      }
    }
#pragma unroll
    for (int g = 0; g < GROUP; ++g)
      stage<3>(ring, src, u0 + g + RING, at.len, w);
  }
  wait_groups<0>();
  work[at.slot] = make_float4(lf_sum, c, n, m);
}

// Phase 2: one thread a feature; each chunk's summary is replaced by the
// state (c, n, m, 0) at the chunk's start, the first's (0, 0, 0).
__global__ void __launch_bounds__(THREADS)
slstm_carry_kernel(float4* __restrict__ work, long long columns, int w,
                   int chunks) {
  constexpr int AHEAD = 8;   // summaries loaded before they are combined
  const long long col = static_cast<long long>(blockIdx.x) * THREADS +
                        threadIdx.x;
  if (col >= columns) return;
  float4* p = work + (col / w) * chunks * static_cast<long long>(w) +
              col % w;
  float c = 0.f, n = 0.f, m = 0.f;   // m starts at 0, as the reference's
  for (int k0 = 0; k0 < chunks; k0 += AHEAD) {
    float4 sum[AHEAD];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u)
      if (k0 + u < chunks) sum[u] = p[static_cast<long long>(k0 + u) * w];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      if (k0 + u < chunks) {
        p[static_cast<long long>(k0 + u) * w] = make_float4(c, n, m, 0.f);
        const float a = m + sum[u].x;
        const float m_end = fmaxf(a, sum[u].w);
        const float carried = expf(a - m_end);
        const float own = expf(sum[u].w - m_end);
        c = c * carried + sum[u].y * own;
        n = n * carried + sum[u].z * own;
        m = m_end;
      }
    }
  }
}

// Phase 3: each (feature, chunk) from its carried start state -> y, and
// the per-step c, n, m where cs is not null.
__global__ void __launch_bounds__(THREADS)
slstm_output_kernel(const float* __restrict__ z, const float* __restrict__ gi,
                    const float* __restrict__ gf,
                    const float* __restrict__ go,
                    const float4* __restrict__ work, float* __restrict__ y,
                    float* __restrict__ cs, float* __restrict__ ns,
                    float* __restrict__ ms, long long columns, int s, int w,
                    int chunk, int chunks) {
  __shared__ float ring[RING][4][THREADS];
  const long long col = static_cast<long long>(blockIdx.x) * THREADS +
                        threadIdx.x;
  if (col >= columns) return;
  const ChunkAt at = chunk_at(col, s, w, chunk, chunks);
  const float* src[4] = {z + at.base, gi + at.base, gf + at.base,
                         go + at.base};
#pragma unroll
  for (int u = 0; u < RING; ++u) stage<4>(ring, src, u, at.len, w);
  const float4 start = work[at.slot];
  float c = start.x, n = start.y, m = start.z;
  long long out = at.base;
  for (int u0 = 0; u0 < at.len; u0 += GROUP) {
    wait_groups<RING - GROUP>();
    float th[GROUP], ir[GROUP], lf[GROUP], gate[GROUP];
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      const int slot = (u0 + g) % RING;
      th[g] = tanhf(ring[slot][0][threadIdx.x]);
      ir[g] = ring[slot][1][threadIdx.x];
      lf[g] = log_sigmoid(ring[slot][2][threadIdx.x]);
      gate[g] = sigmoid(ring[slot][3][threadIdx.x]);
    }
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      if (u0 + g < at.len) {
        const float m_new = fmaxf(lf[g] + m, ir[g]);
        const float i_st = expf(ir[g] - m_new);
        const float f_st = expf(lf[g] + m - m_new);
        c = f_st * c + i_st * th[g];
        n = f_st * n + i_st;
        m = m_new;
        y[out] = gate[g] * c / fmaxf(n, 1.f);
        if (cs) {
          cs[out] = c;
          ns[out] = n;
          ms[out] = m;
        }
        out += w;
      }
    }
#pragma unroll
    for (int g = 0; g < GROUP; ++g)
      stage<4>(ring, src, u0 + g + RING, at.len, w);
  }
  wait_groups<0>();
}

// Stages step u of a chunk of the backward, counted from its last step
// (its step len - 1 - u, at t0 + len - 1 - u of the sequence), into its
// ring slot: z, i, f, o, dy at that step and c, n, m one step before
// (zeros at t = 0).  Past the chunk's first step it copies nothing, but
// the group is committed all the same, as in stage.
__device__ __forceinline__ void stage_bwd(
    float (*ring)[NIN_BWD][THREADS], const float* const* src, int u,
    int len, int t0, int w) {
  if (u < len) {
    const int v = len - 1 - u;
    const long long at = static_cast<long long>(v) * w;
    float (*slot)[THREADS] = ring[u % RING_BWD];
#pragma unroll
    for (int q = 0; q < 5; ++q)
      copy_async(&slot[q][threadIdx.x], src[q] + at);
    const bool prev = t0 + v > 0;
#pragma unroll
    for (int q = 5; q < NIN_BWD; ++q)
      copy_async(&slot[q][threadIdx.x], src[q] + (prev ? at - w : at), prev);
  }
  commit();
}

// The inputs of a (feature, chunk) thread of the backward from its chunk's
// first step: z, i, f, o, dy and the saved c, n, m.
struct BwdInputs {
  const float* src[NIN_BWD];
};

__device__ __forceinline__ BwdInputs bwd_inputs(
    const float* z, const float* gi, const float* gf, const float* go,
    const float* dy, const float* cs, const float* ns, const float* ms,
    long long base) {
  return {{z + base, gi + base, gf + base, go + base, dy + base, cs + base,
           ns + base, ms + base}};
}

// Phase 1 of the backward: each (feature, chunk) composes its chunk's map
// (F, W, Oc, On | Pc, Pn, Om) from its last step to its first, into the
// two float4 planes of the workspace.
__global__ void __launch_bounds__(THREADS)
slstm_bwd_chunk_kernel(const float* __restrict__ z,
                       const float* __restrict__ gi,
                       const float* __restrict__ gf,
                       const float* __restrict__ go,
                       const float* __restrict__ cs,
                       const float* __restrict__ ns,
                       const float* __restrict__ ms,
                       const float* __restrict__ dy,
                       float4* __restrict__ work, long long plane,
                       long long columns, int s, int w, int chunk,
                       int chunks) {
  __shared__ float ring[RING_BWD][NIN_BWD][THREADS];
  const long long col = static_cast<long long>(blockIdx.x) * THREADS +
                        threadIdx.x;
  if (col >= columns) return;
  const ChunkAt at = chunk_at(col, s, w, chunk, chunks);
  const int t0 = blockIdx.y * chunk;
  const BwdInputs in = bwd_inputs(z, gi, gf, go, dy, cs, ns, ms, at.base);
#pragma unroll
  for (int u = 0; u < RING_BWD; ++u)
    stage_bwd(ring, in.src, u, at.len, t0, w);
  const long long last = at.base + static_cast<long long>(at.len - 1) * w;
  float c = cs[last], n = ns[last], m = ms[last];
  float fm = 1.f, wm = 1.f, oc = 0.f, on = 0.f, pc = 0.f, pn = 0.f,
        om = 0.f;
  for (int u0 = 0; u0 < at.len; u0 += GROUP) {
    wait_groups<RING_BWD - GROUP>();
    float v[GROUP][NIN_BWD];
#pragma unroll
    for (int g = 0; g < GROUP; ++g)
#pragma unroll
      for (int q = 0; q < NIN_BWD; ++q)
        v[g][q] = ring[(u0 + g) % RING_BWD][q][threadIdx.x];
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      if (u0 + g < at.len) {
        const float th = tanhf(v[g][0]), iv = v[g][1], fv = v[g][2];
        const float gate = sigmoid(v[g][3]), dyv = v[g][4];
        const float c_p = v[g][5], n_p = v[g][6], m_p = v[g][7];
        const float d = fmaxf(n, 1.f);
        const float a = log_sigmoid(fv) + m_p;
        const float fs = expf(a - m);
        const float is = expf(iv - m);
        const float al = dyv * gate / d;
        const float be = n >= 1.f ? -(dyv * gate * c / (d * d)) : 0.f;
        const float wa = a > iv ? 1.f : (a == iv ? 0.5f : 0.f);
        const float p = (1.f - wa) * fs * c_p - wa * is * th;
        const float q = (1.f - wa) * fs * n_p - wa * is;
        const float dct = oc + al;
        const float dnt = on + be;
        om = wa * om + p * dct + q * dnt;
        pc = wa * pc + p * fm;
        pn = wa * pn + q * fm;
        wm *= wa;
        oc = fs * dct;
        on = fs * dnt;
        fm *= fs;
        c = c_p;
        n = n_p;
        m = m_p;
      }
    }
#pragma unroll
    for (int g = 0; g < GROUP; ++g)
      stage_bwd(ring, in.src, u0 + g + RING_BWD, at.len, t0, w);
  }
  wait_groups<0>();
  work[at.slot] = make_float4(fm, wm, oc, on);
  work[plane + at.slot] = make_float4(pc, pn, om, 0.f);
}

// Phase 2 of the backward: one thread a feature, from the last chunk to
// the first; each chunk's map is replaced (in the first plane) by the
// (dc, dn, dm, 0) that enters it from its last step, the last chunk's 0.
__global__ void __launch_bounds__(THREADS)
slstm_bwd_carry_kernel(float4* __restrict__ work, long long plane,
                       long long columns, int w, int chunks) {
  constexpr int AHEAD = 8;   // maps loaded before they are applied
  const long long col = static_cast<long long>(blockIdx.x) * THREADS +
                        threadIdx.x;
  if (col >= columns) return;
  const long long first = (col / w) * chunks * static_cast<long long>(w) +
                          col % w;
  float dc = 0.f, dn = 0.f, dm = 0.f;
  for (int k0 = chunks - 1; k0 >= 0; k0 -= AHEAD) {
    float4 lin[AHEAD], row[AHEAD];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      if (k0 - u >= 0) {
        const long long at = first + static_cast<long long>(k0 - u) * w;
        lin[u] = work[at];
        row[u] = work[plane + at];
      }
    }
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      if (k0 - u >= 0) {
        work[first + static_cast<long long>(k0 - u) * w] =
            make_float4(dc, dn, dm, 0.f);
        const float dm_new =
            lin[u].y * dm + row[u].x * dc + row[u].y * dn + row[u].z;
        dc = lin[u].x * dc + lin[u].z;
        dn = lin[u].x * dn + lin[u].w;
        dm = dm_new;
      }
    }
  }
}

// Phase 3 of the backward: each (feature, chunk) from the carried
// (dc, dn, dm) at its last step, t from the chunk's last step down to its
// first, step for step as the plain reverse loop -> dz, di, df, do.
__global__ void __launch_bounds__(THREADS)
slstm_bwd_output_kernel(const float* __restrict__ z,
                        const float* __restrict__ gi,
                        const float* __restrict__ gf,
                        const float* __restrict__ go,
                        const float* __restrict__ cs,
                        const float* __restrict__ ns,
                        const float* __restrict__ ms,
                        const float* __restrict__ dy,
                        const float4* __restrict__ work,
                        float* __restrict__ dz, float* __restrict__ di,
                        float* __restrict__ df, float* __restrict__ dgo,
                        long long columns, int s, int w, int chunk,
                        int chunks) {
  __shared__ float ring[RING_BWD][NIN_BWD][THREADS];
  const long long col = static_cast<long long>(blockIdx.x) * THREADS +
                        threadIdx.x;
  if (col >= columns) return;
  const ChunkAt at = chunk_at(col, s, w, chunk, chunks);
  const int t0 = blockIdx.y * chunk;
  const BwdInputs in = bwd_inputs(z, gi, gf, go, dy, cs, ns, ms, at.base);
#pragma unroll
  for (int u = 0; u < RING_BWD; ++u)
    stage_bwd(ring, in.src, u, at.len, t0, w);
  const long long last = at.base + static_cast<long long>(at.len - 1) * w;
  float c = cs[last], n = ns[last], m = ms[last];
  const float4 carried = work[at.slot];
  float dc = carried.x, dn = carried.y, dm = carried.z;
  long long out = last;
  for (int u0 = 0; u0 < at.len; u0 += GROUP) {
    wait_groups<RING_BWD - GROUP>();
    float v[GROUP][NIN_BWD];
#pragma unroll
    for (int g = 0; g < GROUP; ++g)
#pragma unroll
      for (int q = 0; q < NIN_BWD; ++q)
        v[g][q] = ring[(u0 + g) % RING_BWD][q][threadIdx.x];
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      if (u0 + g < at.len) {
        const float th = tanhf(v[g][0]), iv = v[g][1], fv = v[g][2];
        const float gate = sigmoid(v[g][3]), dyv = v[g][4];
        const float c_p = v[g][5], n_p = v[g][6], m_p = v[g][7];
        const float d = fmaxf(n, 1.f);
        const float a = log_sigmoid(fv) + m_p;
        const float fs = expf(a - m);
        const float is = expf(iv - m);
        const float dct = dc + dyv * gate / d;
        const float dnt = n >= 1.f ? dn - dyv * gate * c / (d * d) : dn;
        const float dfs = dct * c_p + dnt * n_p;
        const float dis = dct * th + dnt;
        const float dml = dm - (dfs * fs + dis * is);
        const float wa = a > iv ? 1.f : (a == iv ? 0.5f : 0.f);
        const float da = dfs * fs + dml * wa;
        dgo[out] = dyv * (c / d) * gate * (1.f - gate);
        dz[out] = dct * is * (1.f - th * th);
        di[out] = dis * is + dml * (1.f - wa);
        df[out] = da * sigmoid(-fv);
        dm = da;
        dc = dct * fs;
        dn = dnt * fs;
        c = c_p;
        n = n_p;
        m = m_p;
        out -= w;
      }
    }
#pragma unroll
    for (int g = 0; g < GROUP; ++g)
      stage_bwd(ring, in.src, u0 + g + RING_BWD, at.len, t0, w);
  }
  wait_groups<0>();
}

long long chunk_count(int s, int chunk) {
  return (static_cast<long long>(s) + chunk - 1) / chunk;
}

}  // namespace

extern "C" long long repro_slstm_scan_workspace(int batch, int s, int w,
                                                int chunk) {
  if (batch < 1 || s < 1 || w < 1 || chunk < 1) return 0;
  return 4LL * batch * chunk_count(s, chunk) * w;
}

extern "C" cudaError_t repro_slstm_scan(const float* z, const float* i,
                                        const float* f, const float* o,
                                        float* y, float* c, float* n,
                                        float* m, float* work,
                                        long long work_floats, int batch,
                                        int s, int w, int chunk,
                                        cudaStream_t stream) {
  if (batch < 1 || s < 1 || w < 1 || chunk < 1) return cudaErrorInvalidValue;
  const long long chunks = chunk_count(s, chunk);
  const long long columns = static_cast<long long>(batch) * w;
  const long long blocks = (columns + THREADS - 1) / THREADS;
  if (chunks > MAX_CHUNKS || blocks > INT_MAX) return cudaErrorInvalidValue;
  if (work_floats < repro_slstm_scan_workspace(batch, s, w, chunk))
    return cudaErrorInvalidDevicePointer;
  if ((c == nullptr) != (n == nullptr) || (c == nullptr) != (m == nullptr))
    return cudaErrorInvalidValue;
  float4* summary = reinterpret_cast<float4*>(work);
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(chunks));
  slstm_chunk_kernel<<<grid, THREADS, 0, stream>>>(
      z, i, f, summary, columns, s, w, chunk, static_cast<int>(chunks));
  slstm_carry_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      summary, columns, w, static_cast<int>(chunks));
  slstm_output_kernel<<<grid, THREADS, 0, stream>>>(
      z, i, f, o, summary, y, c, n, m, columns, s, w, chunk,
      static_cast<int>(chunks));
  return cudaSuccess;
}

extern "C" long long repro_slstm_scan_bwd_workspace(int batch, int s,
                                                    int w, int chunk) {
  if (batch < 1 || s < 1 || w < 1 || chunk < 1) return 0;
  return 8LL * batch * chunk_count(s, chunk) * w;
}

extern "C" cudaError_t repro_slstm_scan_bwd(
    const float* z, const float* i, const float* f, const float* o,
    const float* c, const float* n, const float* m, const float* dy,
    float* dz, float* di, float* df, float* d_o, float* work,
    long long work_floats, int batch, int s, int w, int chunk,
    cudaStream_t stream) {
  if (batch < 1 || s < 1 || w < 1 || chunk < 1) return cudaErrorInvalidValue;
  const long long chunks = chunk_count(s, chunk);
  const long long columns = static_cast<long long>(batch) * w;
  const long long blocks = (columns + THREADS - 1) / THREADS;
  if (chunks > MAX_CHUNKS || blocks > INT_MAX) return cudaErrorInvalidValue;
  if (work_floats < repro_slstm_scan_bwd_workspace(batch, s, w, chunk))
    return cudaErrorInvalidDevicePointer;
  float4* maps = reinterpret_cast<float4*>(work);
  const long long plane = chunks * columns;   // float4s a plane
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(chunks));
  slstm_bwd_chunk_kernel<<<grid, THREADS, 0, stream>>>(
      z, i, f, o, c, n, m, dy, maps, plane, columns, s, w, chunk,
      static_cast<int>(chunks));
  slstm_bwd_carry_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                           stream>>>(maps, plane, columns, w,
                                     static_cast<int>(chunks));
  slstm_bwd_output_kernel<<<grid, THREADS, 0, stream>>>(
      z, i, f, o, c, n, m, dy, maps, dz, di, df, d_o, columns, s, w, chunk,
      static_cast<int>(chunks));
  return cudaSuccess;
}
