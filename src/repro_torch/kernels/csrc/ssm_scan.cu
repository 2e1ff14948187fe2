// K5: chunked decayed linear attention (the SSD / mLSTM scan) on the CUDA
// cores (IEEE fp32 FFMA).
//
// Replaces the reference package's Pallas scan
// (src/repro/kernels/ssm_scan/ssm_scan.py, ssm_scan_pallas): per head, the
// recurrence S_t = a_t S_{t-1} + k_t v_t^T, y_t = q_t . S_t with a DK x DV
// fp32 state and every exponent <= 0.  The TPU kernel walks the chunks of a
// head in order on one core and carries the state in VMEM scratch.
//
// What bounds it: at hymba's shape (B 4, H 25, S 4096, DK 16, DV 64, bf16)
// the inputs and the output are 132 MB, 0.04 ms at the memory rate, and the
// chunk form's FFMA work about 0.06 ms at the fp32 peak.  A head's chain of
// chunks is the only sequential part; walked by one CTA a head (100 CTAs
// for 132 SMs) it is pure latency.
//
// What the design does about it: the chunk-parallel form of the reference's
// jnp twin (src/repro/models/ssm.py, decayed_linear_attention), in three
// launches over grids that fill the card.  Chunks are C = 64 rows; the
// state's DV columns evolve independently, so DV is cut into tiles of 64
// columns and no tile needs another's.  With A the inclusive running sum of
// log a over a chunk and total its last value:
//   1. chunk states, one CTA a (DV tile, head, chunk):
//      cs_n = sum_j exp(total - A_j) k_j v_j^T (DK x 64), into a workspace;
//   2. state pass, one thread a state element: walks the chunks in order,
//      S_prev[n] = S, S <- exp(total_n) S + cs_n, in place in the workspace;
//      one FFMA an element a chunk, so it is bound by the workspace's bytes;
//   3. outputs, one CTA a (run of DV tiles, head, chunk):
//      y = exp(A) (q . S_prev) + ((q k^T) * exp(A_i - A_j) [j <= i]) v.
//      The C x C decayed scores are computed once a CTA; at DK >= 128 a CTA
//      takes every DV tile of its chunk so that no tile repeats them.
// At hymba's shape launches 1 and 3 have 6400 CTAs each.  Every product is
// register-tiled: each thread holds a tile of its output (4 x 4 of the
// scores and of y; DK/16 x 4 of a chunk state, or below a padded DK of 64
// a 4 x 4 tile over a share of the rows j) and reads its operands as float4
// from shared memory; a warp of the outputs stops its sum over j at the
// diagonal of its rows.  Rows are loaded with 16-byte vector loads where the
// row strides and widths allow (hymba's heads are views of the projections)
// and element-wise where they do not (xlstm's v with its ones column, rows
// of 514 B).  The tail of the last chunk is zero-filled with log a = 0,
// which is what the reference's zero padding computes.  DK is padded in
// shared memory to 16, 32, 64, 128 or 256 (the widest a tile holds); the
// launcher refuses a wider DK.  The workspace (dk x dv4 floats a head and
// chunk, dv4 = DV rounded up to 4, then one decay a head and chunk) is
// allocated by the caller.  What holds the launches above their bound (the
// load phase of short-lived CTAs, the shared-memory reads of 4 x 4 tiles)
// is measured in PERF.md; not yet used: CTAs that stay resident and load
// the next chunk while computing one, and the tensor cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "kernels.h"

namespace {

constexpr int C = 64;           // chunk rows
constexpr int DVT = 64;         // state columns a tile
constexpr int THREADS = 256;    // 16 x 16 threads, each a register tile
constexpr int LDT = C + 4;      // row length of q, k and P transposed
constexpr int MAX_DK = 256;
constexpr int MAX_DEVICES = 64;
// bits of the flags argument: 16-byte row loads of q, k, v; 4-wide stores of y
constexpr int VEC_Q = 1, VEC_K = 2, VEC_V = 4, VEC_Y = 8;

struct Strides {               // element strides (batch, head, row)
  long long b, h, r;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 bytes of T at p (16-byte aligned) as floats
__device__ __forceinline__ void load16(const float* p, float* f) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* f) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float2 t = __bfloat1622float2(h[u]);
    f[2 * u] = t.x;
    f[2 * u + 1] = t.y;
  }
}

// four consecutive values at p (aligned to four elements)
__device__ __forceinline__ void store4(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* f) {
  uint2 x;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
  h[0] = __floats2bfloat162_rn(f[0], f[1]);
  h[1] = __floats2bfloat162_rn(f[2], f[3]);
  *reinterpret_cast<uint2*>(p) = x;
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// A ROWS x COLS tile whose first element is src (row stride rs) into shared
// memory as fp32: dst[r * ld + c], or dst[c * ld + r] when TRANSPOSED.
// Rows from `rows` and columns from `cols` on are zeros.  vec: 16-byte loads
// (src and rs aligned, cols a multiple of the vector).
template <int ROWS, int COLS, bool TRANSPOSED, typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long rs, int rows, int cols,
                                          bool vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    constexpr int GROUPS = COLS / V;
    for (int e = threadIdx.x; e < ROWS * GROUPS; e += THREADS) {
      const int r = e / GROUPS;
      const int c = e % GROUPS * V;
      float f[V];
      if (r < rows && c < cols) {
        load16(src + r * rs + c, f);
      } else {
#pragma unroll
        for (int u = 0; u < V; ++u) f[u] = 0.f;
      }
      if (TRANSPOSED) {
#pragma unroll
        for (int u = 0; u < V; ++u) dst[(c + u) * ld + r] = f[u];
      } else {
#pragma unroll
        for (int u = 0; u < V; u += 4) store4(dst + r * ld + c + u, f + u);
      }
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * COLS; e += THREADS) {
      const int r = e / COLS;
      const int c = e % COLS;
      const float x = r < rows && c < cols ? widen(src[r * rs + c]) : 0.f;
      if (TRANSPOSED)
        dst[c * ld + r] = x;
      else
        dst[r * ld + c] = x;
    }
  }
}

// Warp 0: A[i], the inclusive running sum of log a over the chunk's rows
// (0 from `rows` on), two rows a lane and a warp scan of the lane sums.
__device__ __forceinline__ void chunk_sums(const float* la, long long ls,
                                           int rows, float* A) {
  const int lane = threadIdx.x;
  const float a0 = 2 * lane < rows ? la[2 * lane * ls] : 0.f;
  const float a1 = 2 * lane + 1 < rows ? la[(2 * lane + 1) * ls] : 0.f;
  float run = a0 + a1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float x = __shfl_up_sync(0xffffffffu, run, off);
    if (lane >= off) run += x;
  }
  A[2 * lane + 1] = run;
  A[2 * lane] = run - a1;
}

// What a CTA of launches 1 and 3 works on: blockIdx.x = group of DV tiles
// + groups * head, blockIdx.y the chunk, blockIdx.z the batch, so that the
// CTAs in flight read whole rows of projections whose heads are column
// slices.  The workspace holds each head's chunk states in chunk order.
struct Block {
  int group, bh, b, h, n, t0, rows;
  long long state;             // offset of its chunk state in the workspace
};

__device__ __forceinline__ Block block_of(int groups, int H, int n_chunks,
                                          int s, int dk, int dv4) {
  Block k;
  k.group = blockIdx.x % groups;
  k.h = blockIdx.x / groups;
  k.n = blockIdx.y;
  k.b = blockIdx.z;
  k.bh = k.b * H + k.h;
  k.t0 = k.n * C;
  k.rows = min(C, s - k.t0);
  k.state = (static_cast<long long>(k.bh) * n_chunks + k.n) * dk * dv4;
  return k;
}

// Launch 1: the chunk state of one (head, chunk, DV tile) into the
// workspace, rows d < dk, columns of the tile below dv4.  Thread (ty, tx)
// holds rows ty * TM .. + TM - 1 and columns tx * 4 .. + 3.  Below a padded
// DK of 64 the rows j of the sum are split into JS groups of threads, so
// that a thread still holds a 4 x 4 tile, and the groups' sums are added
// through shared memory.
template <typename T, int DKP>
__global__ void __launch_bounds__(THREADS)
    ssm_chunk_state_kernel(const T* __restrict__ k, const T* __restrict__ v,
                           const float* __restrict__ la,
                           float* __restrict__ ws, float* __restrict__ decay,
                           int H, int s, int n_chunks, int dk, int dv,
                           int dv4, int tiles, Strides ks, Strides vs,
                           Strides ls, int flags) {
  constexpr int TM = DKP >= 64 ? DKP / 16 : 4;
  constexpr int JS = DKP >= 64 ? 1 : 64 / DKP;
  constexpr int GROUP = THREADS / JS;
  constexpr int JN = C / JS;
  extern __shared__ __align__(16) float smem[];
  float* kd = smem;               // [C][DKP] keys
  float* vt = kd + C * DKP;       // [C][DVT] values of the tile
  float* A = vt + C * DVT;        // [C] running sums
  float* w = A + C;               // [C] exp(total - A_j)
  float* part = smem;             // [JS][DKP][DVT] the groups' sums, after

  const Block blk = block_of(tiles, H, n_chunks, s, dk, dv4);
  const int c0 = blk.group * DVT;
  if (threadIdx.x < 32) {
    chunk_sums(la + blk.b * ls.b + blk.h * ls.h + blk.t0 * ls.r, ls.r,
               blk.rows, A);
    __syncwarp();
    const float total = A[C - 1];
    for (int j = threadIdx.x; j < C; j += 32)
      w[j] = expf(fminf(total - A[j], 0.f));
    if (blk.group == 0 && threadIdx.x == 0)
      decay[static_cast<long long>(blk.bh) * n_chunks + blk.n] = expf(total);
  }
  load_tile<C, DKP, false>(kd, DKP,
                           k + blk.b * ks.b + blk.h * ks.h + blk.t0 * ks.r,
                           ks.r, blk.rows, dk, flags & VEC_K);
  load_tile<C, DVT, false>(vt, DVT,
                           v + blk.b * vs.b + blk.h * vs.h + blk.t0 * vs.r +
                               c0,
                           vs.r, blk.rows, min(DVT, dv - c0), flags & VEC_V);
  __syncthreads();

  const int jg = threadIdx.x / GROUP;
  const int ty = threadIdx.x % GROUP / 16;
  const int tx = threadIdx.x % 16;
  float acc[TM][4];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[r][u] = 0.f;
#pragma unroll 4
  for (int j = jg * JN; j < jg * JN + JN; ++j) {
    float a[TM];
    float bv[4];
#pragma unroll
    for (int r = 0; r < TM; r += 4) load16(kd + j * DKP + ty * TM + r, a + r);
    load16(vt + j * DVT + tx * 4, bv);
    const float wj = w[j];
#pragma unroll
    for (int u = 0; u < 4; ++u) bv[u] *= wj;
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[r][u] = fmaf(a[r], bv[u], acc[r][u]);
  }
  float* out = ws + blk.state + c0;
  if constexpr (JS == 1) {
    if (c0 + tx * 4 < dv4) {
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const int d = ty * TM + r;
        if (d < dk) store4(out + static_cast<long long>(d) * dv4 + tx * 4,
                           acc[r]);
      }
    }
  } else {
    __syncthreads();             // kd and vt are read no more
#pragma unroll
    for (int r = 0; r < TM; ++r)
      store4(part + (jg * DKP + ty * TM + r) * DVT + tx * 4, acc[r]);
    __syncthreads();
    for (int o = threadIdx.x; o < DKP * DVT / 4; o += THREADS) {
      const int d = o / (DVT / 4);
      const int c = o % (DVT / 4) * 4;
      if (d >= dk || c0 + c >= dv4) continue;
      float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int g = 0; g < JS; ++g) {
        float f[4];
        load16(part + (g * DKP + d) * DVT + c, f);
#pragma unroll
        for (int u = 0; u < 4; ++u) sum[u] += f[u];
      }
      store4(out + static_cast<long long>(d) * dv4 + c, sum);
    }
  }
}

// Launch 2: one thread a state element e of a head (elems = dk * dv4 a
// head): S_prev[n] = S, then S <- exp(total_n) S + cs_n, over the chunks in
// order, in place.  Loads come in batches of U so that they are in flight
// together; the state chain is one FFMA a chunk.
__global__ void __launch_bounds__(THREADS)
    ssm_state_pass_kernel(float* __restrict__ ws,
                          const float* __restrict__ decay, long long total,
                          int elems, int n_chunks) {
  constexpr int U = 8;
  const long long g = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (g >= total) return;
  const long long bh = g / elems;
  const long long stride = elems;
  float* p = ws + bh * n_chunks * stride + g % elems;
  const float* dec = decay + bh * n_chunks;
  float state = 0.f;
  int n = 0;
  for (; n + U <= n_chunks; n += U) {
    float cs[U];
    float dn[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      cs[u] = p[(n + u) * stride];
      dn[u] = dec[n + u];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      p[(n + u) * stride] = state;
      state = fmaf(state, dn[u], cs[u]);
    }
  }
  for (; n < n_chunks; ++n) {
    const float cs = p[n * stride];
    p[n * stride] = state;
    state = fmaf(state, dec[n], cs);
  }
}

// Launch 3: the outputs of one (head, chunk) for a run of `per_cta` DV
// tiles.  Thread (ty, tx) holds rows ty * 4 .. + 3 of the scores and of y,
// and columns tx * 4 .. + 3 of each.  The state tile takes k's room once
// the scores are done.
template <typename T, int DKP>
__global__ void __launch_bounds__(THREADS)
    ssm_output_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ la,
                      const float* __restrict__ ws, T* __restrict__ y, int H,
                      int s, int n_chunks, int dk, int dv, int dv4,
                      int tiles, int per_cta, Strides qs, Strides ks,
                      Strides vs, Strides ls, Strides ys, int flags) {
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;               // [DKP][LDT] q transposed
  float* kT = qT + DKP * LDT;     // [DKP][LDT] k transposed
  float* pT = kT + DKP * LDT;     // [C][LDT] decayed scores transposed
  float* vt = pT + C * LDT;       // [C][DVT] values of the tile
  float* A = vt + C * DVT;        // [C] running sums
  float* eA = A + C;              // [C] exp(A)
  float* St = kT;                 // [DKP][DVT] the state tile, after

  const int groups = (tiles + per_cta - 1) / per_cta;
  const Block blk = block_of(groups, H, n_chunks, s, dk, dv4);
  if (threadIdx.x < 32) {
    chunk_sums(la + blk.b * ls.b + blk.h * ls.h + blk.t0 * ls.r, ls.r,
               blk.rows, A);
    __syncwarp();
    for (int i = threadIdx.x; i < C; i += 32) eA[i] = expf(A[i]);
  }
  load_tile<C, DKP, true>(qT, LDT,
                          q + blk.b * qs.b + blk.h * qs.h + blk.t0 * qs.r,
                          qs.r, blk.rows, dk, flags & VEC_Q);
  load_tile<C, DKP, true>(kT, LDT,
                          k + blk.b * ks.b + blk.h * ks.h + blk.t0 * ks.r,
                          ks.r, blk.rows, dk, flags & VEC_K);
  __syncthreads();

  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  {
    // scores q_i . k_j, decayed by exp(A_i - A_j) for j <= i, else 0
    float sc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) sc[r][u] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DKP; ++d) {
      float a[4];
      float bk[4];
      load16(qT + d * LDT + ty * 4, a);
      load16(kT + d * LDT + tx * 4, bk);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u) sc[r][u] = fmaf(a[r], bk[u], sc[r][u]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = tx * 4 + u;
      float col[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty * 4 + r;
        col[r] = 0.f;
        if (j <= i) col[r] = sc[r][u] * expf(fminf(A[i] - A[j], 0.f));
      }
      store4(pT + j * LDT + ty * 4, col);
    }
  }
  __syncthreads();               // pT written; kT free

  // rows i <= 4 * (ty | 1) + 3 of the warp need scores j <= that only
  const int jmax = 4 * (ty | 1) + 4;
  const int last = min(tiles, (blk.group + 1) * per_cta);
  for (int tile = blk.group * per_cta; tile < last; ++tile) {
    const int c0 = tile * DVT;
    load_tile<C, DVT, false>(vt, DVT,
                             v + blk.b * vs.b + blk.h * vs.h +
                                 blk.t0 * vs.r + c0,
                             vs.r, blk.rows, min(DVT, dv - c0),
                             flags & VEC_V);
    load_tile<DKP, DVT, false>(St, DVT, ws + blk.state + c0, dv4, dk,
                               min(DVT, dv4 - c0), true);
    __syncthreads();

    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[r][u] = 0.f;
    // inter-chunk: exp(A_i) (q_i . S_prev)
#pragma unroll 4
    for (int d = 0; d < DKP; ++d) {
      float a[4];
      float b[4];
      load16(qT + d * LDT + ty * 4, a);
      load16(St + d * DVT + tx * 4, b);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[r][u] = fmaf(a[r], b[u], acc[r][u]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float e = eA[ty * 4 + r];
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[r][u] *= e;
    }
    // intra-chunk: the decayed scores times the values
#pragma unroll 4
    for (int j = 0; j < jmax; ++j) {
      float a[4];
      float b[4];
      load16(pT + j * LDT + ty * 4, a);
      load16(vt + j * DVT + tx * 4, b);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[r][u] = fmaf(a[r], b[u], acc[r][u]);
    }
    const int c = c0 + tx * 4;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty * 4 + r;
      if (i >= blk.rows || c >= dv) continue;
      T* row = y + blk.b * ys.b + blk.h * ys.h + (blk.t0 + i) * ys.r + c;
      if ((flags & VEC_Y) && c + 3 < dv) {
        store4(row, acc[r]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (c + u < dv) put(row + u, acc[r][u]);
      }
    }
    __syncthreads();             // before the next tile overwrites vt, St
  }
}

constexpr size_t state_smem(int dkp) {
  return sizeof(float) * (static_cast<size_t>(C) * dkp + C * DVT + 2 * C);
}
constexpr size_t output_smem(int dkp) {
  return sizeof(float) *
         (2 * static_cast<size_t>(dkp) * LDT + C * LDT + C * DVT + 2 * C);
}

struct Args {
  const void *q, *k, *v;
  const float* la;
  void* y;
  float* work;
  int batch, heads, s, dk, dv;
  Strides qs, ks, vs, ls, ys;
  int flags;
};

int chunks_of(int s) { return (s + C - 1) / C; }
int dv4_of(int dv) { return (dv + 3) / 4 * 4; }

// Raises both launches' shared-memory limits above the 48 KB default and
// reads the device's SM count into *sms, once per device: the calls cost
// host time on every launch otherwise.
template <typename T, int DKP>
cudaError_t prepare(int* sms) {
  static std::atomic<int> ready[MAX_DEVICES];  // the SM count once set
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < MAX_DEVICES && (*sms = ready[device].load()) > 0)
    return cudaSuccess;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssm_chunk_state_kernel<T, DKP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(state_smem(DKP)));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssm_output_kernel<T, DKP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(output_smem(DKP)));
  if (err == cudaSuccess && device < MAX_DEVICES) ready[device].store(*sms);
  return err;
}

template <typename T, int DKP>
cudaError_t run(const Args& a, cudaStream_t stream) {
  int sms = 0;
  cudaError_t err = prepare<T, DKP>(&sms);
  if (err != cudaSuccess) return err;
  const int n_chunks = chunks_of(a.s);
  const int dv4 = dv4_of(a.dv);
  const int tiles = (dv4 + DVT - 1) / DVT;
  const long long bhn = static_cast<long long>(a.batch) * a.heads * n_chunks;
  // at DK >= 128 the scores cost about as much as a tile's outputs: one CTA
  // takes every tile of its chunk, where that still leaves two CTAs an SM
  const int per_cta = DKP >= 128 && bhn >= 2LL * sms ? tiles : 1;
  const int groups = (tiles + per_cta - 1) / per_cta;
  const long long elems = static_cast<long long>(a.dk) * dv4;
  const long long total = bhn / n_chunks * elems;
  if (static_cast<long long>(tiles) * a.heads > 0x7fffffffLL ||
      n_chunks > 65535 || a.batch > 65535 ||
      (total + THREADS - 1) / THREADS > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  float* ws = a.work;
  float* decay = a.work + bhn * elems;
  const size_t s1 = state_smem(DKP);
  const size_t s3 = output_smem(DKP);

  const int H = a.heads;
  ssm_chunk_state_kernel<T, DKP>
      <<<dim3(tiles * H, n_chunks, a.batch), THREADS, s1, stream>>>(
          static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.la, ws,
          decay, H, a.s, n_chunks, a.dk, a.dv, dv4, tiles, a.ks, a.vs, a.ls,
          a.flags);
  err = cudaPeekAtLastError();
  if (err != cudaSuccess) return err;
  ssm_state_pass_kernel<<<static_cast<unsigned>((total + THREADS - 1) /
                                                THREADS),
                          THREADS, 0, stream>>>(
      ws, decay, total, static_cast<int>(elems), n_chunks);
  err = cudaPeekAtLastError();
  if (err != cudaSuccess) return err;
  ssm_output_kernel<T, DKP>
      <<<dim3(groups * H, n_chunks, a.batch), THREADS, s3, stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k),
          static_cast<const T*>(a.v), a.la, ws, static_cast<T*>(a.y), H,
          a.s, n_chunks, a.dk, a.dv, dv4, tiles, per_cta, a.qs, a.ks, a.vs,
          a.ls, a.ys, a.flags);
  return cudaSuccess;
}

template <typename T>
cudaError_t run_typed(const Args& a, cudaStream_t stream) {
  if (a.dk <= 16) return run<T, 16>(a, stream);
  if (a.dk <= 32) return run<T, 32>(a, stream);
  if (a.dk <= 64) return run<T, 64>(a, stream);
  if (a.dk <= 128) return run<T, 128>(a, stream);
  return run<T, 256>(a, stream);
}

// Whether rows of a tensor at p with (batch, head, row) strides st start on
// `bytes`-aligned addresses.
bool rows_aligned(const void* p, const long long* st, int esize, int bytes) {
  if (reinterpret_cast<uintptr_t>(p) % bytes) return false;
  for (int i = 0; i < 3; ++i)
    if (st[i] * esize % bytes) return false;
  return true;
}

}  // namespace

extern "C" long long repro_ssm_scan_workspace(int batch, int heads, int s,
                                              int dk, int dv) {
  const long long bhn =
      static_cast<long long>(batch) * heads * chunks_of(s);
  return bhn * (static_cast<long long>(dk) * dv4_of(dv) + 1);
}

extern "C" cudaError_t repro_ssm_scan(const void* q, const void* k,
                                      const void* v, const float* log_a,
                                      void* y, float* work,
                                      long long work_floats, int dtype,
                                      int batch, int heads, int s, int dk,
                                      int dv, const long long* st,
                                      cudaStream_t stream) {
  if (batch < 1 || heads < 1 || s < 1 || dk < 1 || dk > MAX_DK || dv < 1 ||
      (dtype != REPRO_F32 && dtype != REPRO_BF16))
    return cudaErrorInvalidValue;
  if (work_floats < repro_ssm_scan_workspace(batch, heads, s, dk, dv))
    return cudaErrorInvalidDevicePointer;
  const int esize = dtype == REPRO_BF16 ? 2 : 4;
  const int vec = 16 / esize;
  Args a{q, k, v, log_a, y, work, batch, heads, s, dk, dv,
         {st[0], st[1], st[2]}, {st[3], st[4], st[5]}, {st[6], st[7], st[8]},
         {st[9], st[10], st[11]}, {st[12], st[13], st[14]}, 0};
  if (rows_aligned(q, st, esize, 16) && dk % vec == 0) a.flags |= VEC_Q;
  if (rows_aligned(k, st + 3, esize, 16) && dk % vec == 0) a.flags |= VEC_K;
  if (rows_aligned(v, st + 6, esize, 16) && dv % vec == 0) a.flags |= VEC_V;
  if (rows_aligned(y, st + 12, esize, 4 * esize) && dv % 4 == 0)
    a.flags |= VEC_Y;
  if (dtype == REPRO_BF16) return run_typed<__nv_bfloat16>(a, stream);
  return run_typed<float>(a, stream);
}
