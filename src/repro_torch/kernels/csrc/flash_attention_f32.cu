// K4's fp32 body: IEEE FFMA on the CUDA cores, every head dim.
//
// The reference package's Pallas flash kernel
// (src/repro/kernels/flash_attention/flash_attention.py,
// flash_attention_pallas) on fp32 operands; flash_attention.cu holds the
// launcher and the bf16 bodies, and its note the function. IEEE fp32
// throughout, as the repo's fp32 rule wants: the tensor cores take fp32
// only as TF32. What bounds it is the card's 67 TFLOP/s of FFMA: at the
// paths' shapes a CTA does 4 D operations for every (query, key) pair it
// keeps and reads each key and value row once per query tile.
//
// A CTA of 256 threads owns BQ query rows of one (batch, head) and all of
// O's columns, in registers: a thread holds TR rows x 8 columns of every
// tile it computes, so that a 16-byte shared load of Q, K, P or V feeds 16
// (4 x 8) or 32 (8 x 8) FFMAs; one CTA an SM. The launcher picks the tile
// from d and the grid, each the fastest of the tiles timed at the paths'
// shapes (PERF.md, chip_profile.py --k4-f32-designs), and reports it:
//  - d up to 128: 128 rows at 8 x 8 where that grid has a CTA for every SM,
//    else 64 rows at 4 x 8 (four chunks of O, one of them used);
//  - d 256: 64 rows at 8 x 8;
//  - above d 256: 4 x 8 and all the chunks of O that d needs, 64 rows up
//    to d 512 where that grid has a CTA for every SM, else 32.
// Q, scaled in fp32 as the reference scales, is loaded into shared memory
// once. K and V stream through a double buffer in shared memory, each
// stage four 16-byte cp.async copies a thread, zero-filled past the
// edges, the next stage's copies in flight while this one's FFMAs run,
// one barrier a stage: key tiles of 128 (256) keys, the scores' stages
// over d, then V's stages over the tile's keys for each chunk of O's
// columns. The online softmax runs in registers, a row's max and sum
// reduced over its column group with warp shuffles, an accurate expf a
// score; P goes through shared memory (transposed) into P V. The TPU
// kernel's sequential kv grid axis becomes the loop over key tiles; its
// plan blocks (bq/bkv) are VMEM choices and set nothing here. Key tiles
// wholly above the causal diagonal are never visited and the CTAs with the
// longest causal rows are scheduled first. Tried and not kept (PERF.md): a
// ring of three stages, the d loop not unrolled, __expf for expf, each
// within a few per cent either way; 4 x 8 tiles of one chunk at two CTAs an
// SM (128 registers, with spills), 0.96-1.31x the kept tiles' times.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "flash_attention_f32.cuh"
#include "hopper.cuh"
#include "kernels.h"

namespace {

using repro_hopper::smem_u32;

constexpr float NEG_INF = -1e30f;

constexpr int THREADS = 256;

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
                                           bool valid) {
  // 16 bytes, or zeros where the source lies outside the operand
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The tiles of a CTA of BQ query rows: its 256 threads are RG row groups of
// TR rows by CG column groups, and a thread owns TR rows by 8 columns of
// every tile it computes: of the scores, 8 of a tile's BKV keys (key tx +
// CG c), and of each chunk of W columns of O (two runs of 4: tx * 4 and 4 *
// CG + tx * 4). Each stage of the double buffer is four 16-byte copies a
// thread: DS columns of BKV keys of K, or KS keys of W columns of V.
template <int BQ, int TR>
struct Tiles {
  static constexpr int RG = BQ / TR;
  static constexpr int CG = THREADS / RG;
  static constexpr int BKV = 8 * CG;            // keys of a tile: 128, 256
  static constexpr int W = 8 * CG;              // columns of O a chunk
  static constexpr int DS = 4096 / BKV;         // columns of K a stage
  static constexpr int KLD = DS + 4;            // row stride of K's stage
  static constexpr int KS = 4096 / W;           // keys of V a stage
  static constexpr int KG = BKV / KS;           // stages of V a chunk
  static constexpr int PLD = BQ + 4;            // row stride of P^T
  static constexpr int BUF = BKV * KLD > KS * W ? BKV * KLD : KS * W;
  static_assert(TR % 4 == 0 && RG * CG == THREADS && CG <= 32,
                "row groups of float4 rows, column groups within a warp");
  // Q [BQ][d + 4], two stage buffers, P^T [BKV][PLD], in floats
  static size_t bytes(int d) {
    return sizeof(float) * (static_cast<size_t>(BQ) * (d + 4) + 2 * BUF +
                            static_cast<size_t>(BKV) * PLD);
  }
};

// One CTA: BQ query rows of one (batch, head), all d columns of O in
// registers (TR rows x 8 columns a chunk, a thread; NCH chunks at most). Q,
// scaled, is loaded into shared memory once. Each key tile is a run of
// stages, each one buffer filled by 16-byte cp.async copies while the other
// buffer is multiplied, one barrier a stage: d / DS stages of K (BKV keys x
// DS columns), the
// online softmax, then for each chunk of O's columns KG stages of V (KS
// keys x W columns); columns past d are zero-filled and their products
// never stored. Every FFMA is IEEE fp32; every element of S sums its
// products in ascending d.
template <int BQ, int TR, int NCH>
__global__ void __launch_bounds__(THREADS, 1)
    flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int H, int group, int sq, int skv, int d, long long qsb,
                     long long qsh, long long qss, long long ksb,
                     long long ksh, long long kss, long long vsb,
                     long long vsh, long long vss, long long osb,
                     long long osh, long long oss, float scale, int causal) {
  using T = Tiles<BQ, TR>;
  constexpr int CG = T::CG;
  constexpr int NC = NCH * 8;
  extern __shared__ __align__(16) float smem[];
  const int qld = d + 4;
  float* Qs = smem;                          // [BQ][d + 4], scaled
  float* bufs = Qs + BQ * qld;               // [2][BUF]
  float* Pt = bufs + 2 * T::BUF;             // [BKV][PLD]

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
  const int tx = tid % CG;
  const int ty = tid / CG;

  // the query tile, scaled in fp32 as the reference scales, zeros past sq
  for (int e = tid; e < BQ * d / 4; e += THREADS) {
    const int r = e / (d / 4);
    const int c = (e % (d / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < sq) {
      x = *reinterpret_cast<const float4*>(q + (q0 + r) * qss + c);
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
    }
    *reinterpret_cast<float4*>(&Qs[r * qld + c]) = x;
  }

  const int kv_end = causal ? min(skv, q0 + BQ) : skv;
  const int n_kv = (kv_end + T::BKV - 1) / T::BKV;
  const int nsk = d / T::DS;                    // stages of K a tile
  const int nch = (d + T::W - 1) / T::W;        // chunks of O's columns
  const int per_tile = nsk + nch * T::KG;

  // the copies of one stage: the u-th of key tile t, into buffer `buf`
  auto issue = [&](int t, int u, int buf) {
    const uint32_t dst = smem_u32(bufs + buf * T::BUF);
    const int k0 = t * T::BKV;
    if (u < nsk) {
      const int c0 = u * T::DS;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = tid + i * THREADS;
        const int key = e / (T::DS / 4);
        const int c4 = e % (T::DS / 4);
        const bool ok = k0 + key < skv;
        cp_async16(dst + 4 * (key * T::KLD + c4 * 4),
                   ok ? k + (k0 + key) * kss + c0 + c4 * 4 : k, ok);
      }
    } else {
      const int cg = (u - nsk) / T::KG;
      const int key0 = k0 + (u - nsk) % T::KG * T::KS;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = tid + i * THREADS;
        const int key = e / (T::W / 4);
        const int col = cg * T::W + e % (T::W / 4) * 4;
        const bool ok = key0 + key < skv && col < d;
        cp_async16(dst + 4 * (key * T::W + col - cg * T::W),
                   ok ? v + (key0 + key) * vss + col : v, ok);
      }
    }
    cp_async_commit();
  };
  // the stage counter g and the next stage to issue (tile nt, index nu)
  int g = 0, nt = 0, nu = 0;
  auto advance = [&]() {
    if (++nu == per_tile) {
      nu = 0;
      ++nt;
    }
  };
  // waits for stage g's copies (and every thread's work on stage g - 1),
  // issues stage g + 1 into the other buffer, returns stage g's buffer
  auto begin = [&]() -> const float* {
    cp_async_wait_all();
    __syncthreads();
    if (nt < n_kv) {
      issue(nt, nu, (g + 1) & 1);
      advance();
    }
    return bufs + (g++ & 1) * T::BUF;
  };

  float acc[TR][NC];
  float m[TR], l[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  issue(0, 0, 0);
  advance();
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * T::BKV;
    float s[TR][8];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[i][c] = 0.f;
    for (int u = 0; u < nsk; ++u) {
      const float* Ks = begin();
      const float* Qc = Qs + ty * TR * qld + u * T::DS;
#pragma unroll 2
      for (int dd = 0; dd < T::DS; dd += 4) {
        float4 a[TR];
#pragma unroll
        for (int i = 0; i < TR; ++i)
          a[i] = *reinterpret_cast<const float4*>(Qc + i * qld + dd);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float4 w = *reinterpret_cast<const float4*>(
              Ks + (tx + CG * c) * T::KLD + dd);
#pragma unroll
          for (int i = 0; i < TR; ++i) {
            s[i][c] = fmaf(a[i].x, w.x, s[i][c]);
            s[i][c] = fmaf(a[i].y, w.y, s[i][c]);
            s[i][c] = fmaf(a[i].z, w.z, s[i][c]);
            s[i][c] = fmaf(a[i].w, w.w, s[i][c]);
          }
        }
      }
    }

    // mask, then the online-softmax update of the reference, row by row;
    // P^T goes to shared memory (its last readers, the previous tile's
    // stages of V, are past this tile's first barrier)
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int row = q0 + ty * TR + i;
      float mt = NEG_INF;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = k0 + tx + CG * c;
        const bool valid = col < skv && (!causal || row >= col);
        s[i][c] = valid ? s[i][c] : NEG_INF;
        mt = fmaxf(mt, s[i][c]);
      }
#pragma unroll
      for (int off = CG / 2; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        s[i][c] = expf(s[i][c] - m_new);
        ps += s[i][c];
      }
#pragma unroll
      for (int off = CG / 2; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * alpha + ps;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int i = 0; i < TR; i += 4)
        *reinterpret_cast<float4*>(&Pt[(tx + CG * c) * T::PLD + ty * TR + i]) =
            make_float4(s[i][c], s[i + 1][c], s[i + 2][c], s[i + 3][c]);

    // O += P V, chunk by chunk of O's columns; a chunk's second run of 4
    // columns a thread is skipped where it lies wholly past d
#pragma unroll
    for (int cg = 0; cg < NCH; ++cg) {
      if (cg >= nch) break;
      const bool second = cg * T::W + 4 * CG < d;
      for (int kg = 0; kg < T::KG; ++kg) {
        const float* Vs = begin();
        const float* P = Pt + kg * T::KS * T::PLD + ty * TR;
#pragma unroll 4
        for (int j = 0; j < T::KS; ++j) {
          float pv[TR];
#pragma unroll
          for (int i = 0; i < TR; i += 4) {
            const float4 p =
                *reinterpret_cast<const float4*>(P + j * T::PLD + i);
            pv[i] = p.x;
            pv[i + 1] = p.y;
            pv[i + 2] = p.z;
            pv[i + 3] = p.w;
          }
          const float4 w0 =
              *reinterpret_cast<const float4*>(Vs + j * T::W + tx * 4);
#pragma unroll
          for (int i = 0; i < TR; ++i) {
            acc[i][cg * 8 + 0] = fmaf(pv[i], w0.x, acc[i][cg * 8 + 0]);
            acc[i][cg * 8 + 1] = fmaf(pv[i], w0.y, acc[i][cg * 8 + 1]);
            acc[i][cg * 8 + 2] = fmaf(pv[i], w0.z, acc[i][cg * 8 + 2]);
            acc[i][cg * 8 + 3] = fmaf(pv[i], w0.w, acc[i][cg * 8 + 3]);
          }
          if (second) {
            const float4 w1 = *reinterpret_cast<const float4*>(
                Vs + j * T::W + 4 * CG + tx * 4);
#pragma unroll
            for (int i = 0; i < TR; ++i) {
              acc[i][cg * 8 + 4] = fmaf(pv[i], w1.x, acc[i][cg * 8 + 4]);
              acc[i][cg * 8 + 5] = fmaf(pv[i], w1.y, acc[i][cg * 8 + 5]);
              acc[i][cg * 8 + 6] = fmaf(pv[i], w1.z, acc[i][cg * 8 + 6]);
              acc[i][cg * 8 + 7] = fmaf(pv[i], w1.w, acc[i][cg * 8 + 7]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int row = q0 + ty * TR + i;
    if (row >= sq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int cg = 0; cg < NCH; ++cg)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int col = cg * T::W + r * 4 * CG + tx * 4;
        if (cg < nch && col < d)
          *reinterpret_cast<float4*>(o + row * oss + col) = make_float4(
              acc[i][cg * 8 + 4 * r] / li, acc[i][cg * 8 + 4 * r + 1] / li,
              acc[i][cg * 8 + 4 * r + 2] / li,
              acc[i][cg * 8 + 4 * r + 3] / li);
      }
  }
}

// The widest d whose O 64-row tiles of 4 rows a thread hold in registers
// (4 chunks of 128 columns); above it 32-row tiles (3 chunks of 256, up to
// the launcher's widest, 768).
constexpr int MAX_D64 = 4 * Tiles<64, 4>::W;

// 16-byte cp.async and float4 stores need 16-byte aligned operands with
// (batch, head, row) strides in multiples of 4 floats wherever they move.
bool aligned(const void* p, const long long* st, int n0, int n1, int n2) {
  const int n[3] = {n0, n1, n2};
  if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  for (int i = 0; i < 3; ++i)
    if (n[i] > 1 && st[i] % 4 != 0) return false;
  return true;
}

template <int BQ, int TR, int NCH>
cudaError_t launch_at(const void* q, const void* k, const void* v, void* o,
                      int batch, int heads, int kv_heads, int sq, int skv,
                      int d, const long long* st, float scale, int causal,
                      cudaStream_t stream) {
  const size_t smem = Tiles<BQ, TR>::bytes(d);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<BQ, TR, NCH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, batch * heads);
  flash_f32_kernel<BQ, TR, NCH><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), heads,
      heads / kv_heads, sq, skv, d, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], scale, causal);
  return cudaSuccess;
}

}  // namespace

namespace repro_k4 {

// The tile at d for a grid of batch * heads (batch, head) pairs of sq query
// rows, as the file's note sets out, on the current device; -1 if its SMs
// cannot be read.
int f32_tile(int d, int batch, int heads, int sq) {
  int dev = 0;
  int sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return -1;
  const auto fills = [&](int rows) {
    return static_cast<long long>(batch) * heads * ((sq + rows - 1) / rows) >=
           sms;
  };
  if (d <= 128)
    return fills(128) ? REPRO_K4_F32_128X8X1 : REPRO_K4_F32_64X4X4;
  if (d <= 256) return REPRO_K4_F32_64X8X1;
  return d <= MAX_D64 && fills(64) ? REPRO_K4_F32_64X4X4
                                   : REPRO_K4_F32_32X4X3;
}

cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       void* o, int batch, int heads, int kv_heads, int sq,
                       int skv, int d, const long long* st, float scale,
                       int causal, int* body, cudaStream_t stream) {
  if (!aligned(q, st, batch, heads, sq) ||
      !aligned(k, st + 3, batch, kv_heads, skv) ||
      !aligned(v, st + 6, batch, kv_heads, skv) ||
      !aligned(o, st + 9, batch, heads, sq))
    return cudaErrorMisalignedAddress;
  *body = f32_tile(d, batch, heads, sq);
#define REPRO_K4_F32(BQ, TR, NCH)                                           \
  return launch_at<BQ, TR, NCH>(q, k, v, o, batch, heads, kv_heads, sq, skv, \
                                d, st, scale, causal, stream)
  switch (*body) {
    case REPRO_K4_F32_128X8X1: REPRO_K4_F32(128, 8, 1);
    case REPRO_K4_F32_64X8X1: REPRO_K4_F32(64, 8, 1);
    case REPRO_K4_F32_64X4X4: REPRO_K4_F32(64, 4, 4);
    case REPRO_K4_F32_32X4X3: REPRO_K4_F32(32, 4, 3);
  }
#undef REPRO_K4_F32
  return cudaErrorInvalidDevice;
}

// The shared memory the body asks for at d above 256: the most that any
// tiles taking d ask for.
size_t f32_bytes(int d) {
  return d <= MAX_D64 ? Tiles<64, 4>::bytes(d) : Tiles<32, 4>::bytes(d);
}

}  // namespace repro_k4
