// K4: forward GQA attention with an online softmax on the CUDA cores (fp32
// FFMA).
//
// Replaces the reference package's Pallas flash kernel
// (src/repro/kernels/flash_attention/flash_attention.py,
// flash_attention_pallas): the same function -- softmax(q k^T * scale) v per
// query head, the kv head being h / (H / KV), causal or not, columns at or
// past the kv length masked to -1e30, a running max and sum per row with an
// fp32 accumulator, a row whose sum is 0 divided by 1, the result written in
// q's type -- thought through again for Hopper rather than carried over.
//
// What bounds it: per query row it does 4 * D operations for every key it
// sees and reads each key and value row once per 64-row query tile, so at
// the prefill's shapes (S = 4096, D = 128) it is far above the card's
// operations-per-byte balance and bound by operations. On the CUDA cores
// that is 67 TFLOP/s of fp32 FFMA; the bf16 bound of the tensor cores is
// 15x lower and needs mma/wgmma, which this first kernel does not use.
//
// What the design does about it: one CTA of 256 threads owns a 64-row query
// tile of one (batch, head) and walks the key/value rows in tiles of 64.
// The TPU kernel's sequential kv grid axis becomes this loop; its plan
// blocks (bq/bkv) are VMEM choices and set nothing here. Tiles wholly above
// the causal diagonal are never visited, which halves the work at Sq = Skv,
// and the CTAs with the longest causal rows are scheduled first. The query
// tile (scaled in fp32 after widening, as the reference scales) and the key
// tile sit transposed in shared memory so that each thread reads float4 rows
// of both: a thread owns a 4x4 block of scores and does 16 FFMAs per two
// shared loads. The scores' row max and sum are reduced over the 16 threads
// of a row with warp shuffles; the probabilities go through shared memory
// (transposed) into the P.V product, where a thread owns 4 rows x D/16
// columns of the accumulator. The value tile reuses the key tile's buffer,
// so a CTA needs 85 KB at D = 128 and two CTAs fit an SM. Ragged edges are
// zero-filled on load and masked on store: nothing is padded. q, k, v and o
// are addressed by (batch, head, row) strides, so the heads split out of
// the projections need no copy.
// Not yet used: mma.sync / wgmma, TMA and a load pipeline -- later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "kernels.h"

namespace {

constexpr int BQ = 64;          // query rows of a CTA
constexpr int BKV = 64;         // key / value rows of one step
constexpr int THREADS = 256;    // 16 x 16: ty owns 4 rows, tx 4 columns
constexpr int LDT = BQ + 4;     // row stride of the transposed tiles
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int D>
constexpr size_t smem_bytes() {
  // Qt [D][LDT], the k (transposed) / v buffer [D][LDT], Pt [BKV][LDT]
  return sizeof(float) * (2 * D * LDT + BKV * LDT);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H,
                 int group, int sq, int skv, long long qsb, long long qsh,
                 long long qss, long long ksb, long long ksh, long long kss,
                 long long vsb, long long vsh, long long vss, long long osb,
                 long long osh, long long oss, float scale, int causal) {
  static_assert(D % 32 == 0 && D <= 128, "head dim");
  constexpr int NC = D / 16;     // accumulator columns of a thread
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;              // [D][LDT]  q tile, transposed and scaled
  float* KV = Qt + D * LDT;      // [D][LDT] k tile transposed; [BKV][D] v
  float* Pt = KV + D * LDT;      // [BKV][LDT] probabilities, transposed

  const int n_q = (sq + BQ - 1) / BQ;
  const int q0 = (n_q - 1 - blockIdx.x) * BQ;   // longest causal rows first
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int hk = h / group;
  q += b * qsb + h * qsh;
  k += b * ksb + hk * ksh;
  v += b * vsb + hk * vsh;
  o += b * osb + h * osh;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D;
    const int d = e % D;
    const int row = q0 + r;
    Qt[d * LDT + r] = row < sq ? widen(q[row * qss + d]) * scale : 0.f;
  }

  float acc[4][NC];
  float m[4];
  float l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // key tiles that start at or before the tile's last row (causal), or all
  const int kv_end = causal ? min(skv, q0 + BQ) : skv;
  const int n_kv = (kv_end + BKV - 1) / BKV;
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * BKV;
    __syncthreads();   // the last step's reads of KV and Pt are done
    for (int e = tid; e < BKV * D; e += THREADS) {
      const int r = e / D;
      const int d = e % D;
      const int col = k0 + r;
      KV[d * LDT + r] = col < skv ? widen(k[col * kss + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * LDT + ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&KV[d * LDT + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    // mask, then the online-softmax update of the reference, row by row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        const bool valid = col < skv && (!causal || row >= col);
        s[i][j] = valid ? s[i][j] : NEG_INF;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        ps += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * alpha + ps;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Pt[(tx * 4 + j) * LDT + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();   // every thread is done with the key tile

    for (int e = tid; e < BKV * D; e += THREADS) {
      const int r = e / D;
      const int d = e % D;
      const int col = k0 + r;
      KV[r * D + d] = col < skv ? widen(v[col * vss + d]) : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(&Pt[j * LDT + ty * 4]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int g = 0; g < D / 32; ++g) {
        const float2 w =
            *reinterpret_cast<const float2*>(&KV[j * D + g * 32 + tx * 2]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][2 * g] = fmaf(pv[i], w.x, acc[i][2 * g]);
          acc[i][2 * g + 1] = fmaf(pv[i], w.y, acc[i][2 * g + 1]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = (c / 2) * 32 + tx * 2 + (c & 1);
      put(&o[row * oss + col], acc[i][c] / li);
    }
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* o, int batch,
            int heads, int kv_heads, int sq, int skv, const long long* st,
            float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaFuncSetAttribute(flash_kernel<T, D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const dim3 grid((sq + BQ - 1) / BQ, batch * heads);
  flash_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), heads,
      heads / kv_heads, sq, skv, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], scale, causal);
}

template <typename T>
void launch_d(const void* q, const void* k, const void* v, void* o, int batch,
              int heads, int kv_heads, int sq, int skv, int d,
              const long long* st, float scale, int causal,
              cudaStream_t stream) {
  switch (d) {
    case 64:
      launch<T, 64>(q, k, v, o, batch, heads, kv_heads, sq, skv, st, scale,
                    causal, stream);
      break;
    case 96:
      launch<T, 96>(q, k, v, o, batch, heads, kv_heads, sq, skv, st, scale,
                    causal, stream);
      break;
    default:
      launch<T, 128>(q, k, v, o, batch, heads, kv_heads, sq, skv, st, scale,
                     causal, stream);
  }
}

}  // namespace

extern "C" void repro_flash_attention(const void* q, const void* k,
                                      const void* v, void* o, int dtype,
                                      int batch, int heads, int kv_heads,
                                      int sq, int skv, int d,
                                      const long long* strides, float scale,
                                      int causal, cudaStream_t stream) {
  if (dtype == REPRO_BF16)
    launch_d<__nv_bfloat16>(q, k, v, o, batch, heads, kv_heads, sq, skv, d,
                            strides, scale, causal, stream);
  else
    launch_d<float>(q, k, v, o, batch, heads, kv_heads, sq, skv, d, strides,
                    scale, causal, stream);
}
