// K2: diagonal-block triangular solve X U = B (U upper-triangular, nb x nb).
//
// Replaces the reference package's Pallas kernel
// (src/repro/kernels/trsm/trsm.py, trsm_diag_pallas): the column recurrence
// x_k = (b_k - X[:, :k] U[:k, k]) / U[k, k] in fp32, every row of B
// independent.  The blocked wrapper (kernels/trsm/ops.py) sends all the
// off-diagonal O(n^3) work to K1, and the Cholesky's panels come here too.
//
// What bounds it: per launch m*nb^2 operations on 2*m*nb + nb^2/2 elements
// (at m = 16128, nb = 256: 1.06 Gflop on 33 MB), so the card's bound is
// operations, IEEE fp32 FFMA; within a row the nb columns form a dependent
// chain, which bounds the small-m calls (the Cholesky's last panels).
//
// What the design does about it: each CTA of 128 threads owns a strip of
// 64 rows of B and walks nb left-looking in panels of 32 columns (the last
// may be narrower).  For panel p:
//   1. acc = B[:, panel] - X[:, :32p] U[:32p, panel], a register-tiled FFMA
//      product over chunks of 32: a thread owns 4 rows (16 apart, so a
//      warp's float4 reads hit distinct banks) x 4 columns, 16 FFMAs per 2
//      float4 loads.  U's chunks and the strip's older X (written to global
//      memory two or more panels back, read again through L2) arrive by
//      cp.async through a ring of 4 stages (16-byte copies when every row
//      is 16-byte aligned, 4-byte ones otherwise), each thread with fixed
//      rows and column granule to copy; the freshest chunk, X of panel
//      p - 1, is read where the solve left it in shared memory, so no load
//      waits on a store;
//   2. acc is solved against U's 32 x 32 diagonal tile, a thread a row, the
//      row in registers: a 32-step chain of one multiply by the tile's
//      reciprocal diagonal (computed once per tile) and FMAs with the tile's
//      row broadcast from shared memory as float4.  The next panel's
//      diagonal tile, B columns and first chunk load meanwhile;
//   3. X[:, panel] is written out.
// Shared memory is 87 KB whatever nb is, so two CTAs fit an SM at every
// block width, and m = 16128 gives 252 CTAs, one wave.  Each x_k sums its
// terms in ascending column order, as the recurrence reads; only the
// reciprocal (one rounding) differs from the reference's division.  B may
// be a strided column slice (row stride ldb).
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "kernels.h"

namespace {

constexpr int BM = 64;  // rows of B per CTA
constexpr int W = 32;   // panel and chunk width
constexpr int THREADS = 128;
constexpr int STAGES = 4;  // chunks in flight
constexpr int XS = W + 4;  // row stride of a strip tile: 9 granules

struct Stage {
  float x[BM][XS];  // X[strip, chunk] (unused for the freshest chunk)
  float u[W][W];    // U[chunk, panel]
};

struct Shared {
  Stage ring[STAGES];
  float d[2][W][W];     // U[panel, panel], the diagonal tile, by panel parity
  float b[BM][XS];      // B[strip, panel]
  float s[2][BM][XS];   // X[strip, panel], by panel parity
  float rinv[W];        // 1 / U[k, k] over the panel
};

__device__ __forceinline__ float part(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// 4-byte cp.async; zero-fills the word when !valid (src is then not read)
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           bool valid) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copies words (0..4) of src into the 16-byte granule at dst and zero-fills
// the rest: one 16-byte cp.async (L2 only) when VEC, whose operands are
// then 16-byte aligned, else four 4-byte ones.  src is not read for the
// words that are zero-filled.
template <bool VEC>
__device__ __forceinline__ void copy_granule(float* dst, const float* src,
                                             int words) {
  if (VEC) {
    const unsigned addr =
        static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
                 "l"(src), "r"(4 * words));
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      copy_async(dst + e, e < words ? src + e : src, e < words);
  }
}

// A thread's share of every tile copy, fixed for the whole kernel: column
// granule cg of the strip rows row + 16 k and of the U rows row + 16 k.
struct Roles {
  const float* x[4];  // X[r0 + row + 16 k, 4 cg], or X when out of range
  const float* b[4];  // B[r0 + row + 16 k, 4 cg], or B
  int xwords[4];      // 4, or 0 past the last row
  const float* u[2];  // U[row + 16 k, 4 cg]
  const float* U;
  long long ldu;
  int nb, row, cg;
};

__device__ __forceinline__ int words_from(int nb, int col) {
  return max(0, min(4, nb - col));
}

// chunk q of panel p: U[32q.., panel] and, unless it is the freshest chunk
// (q = p - 1, still in s), the strip's X[:, 32q..] from global memory
template <bool VEC>
__device__ __forceinline__ void load_chunk(Shared& sh, const Roles& t, int p,
                                           int q) {
  Stage& st = sh.ring[q % STAGES];
  const int c0 = W * p;
  if (q + 1 < p) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      copy_granule<VEC>(&st.x[t.row + 16 * k][4 * t.cg],
                        t.xwords[k] ? t.x[k] + W * q : t.x[k], t.xwords[k]);
  }
  const int words = words_from(t.nb, c0 + 4 * t.cg);
#pragma unroll
  for (int k = 0; k < 2; ++k)
    copy_granule<VEC>(&st.u[t.row + 16 * k][4 * t.cg],
                      words ? t.u[k] + W * q * t.ldu + c0 : t.U, words);
}

// what panel p needs besides its chunks: U's diagonal tile and B's columns;
// with chunk 0, one group
template <bool VEC>
__device__ __forceinline__ void load_head(Shared& sh, const Roles& t, int p) {
  const int c0 = W * p;
  const int words = words_from(t.nb, c0 + 4 * t.cg);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int n = c0 + t.row + 16 * k < t.nb ? words : 0;
    copy_granule<VEC>(&sh.d[p & 1][t.row + 16 * k][4 * t.cg],
                      n ? t.u[k] + c0 * t.ldu + c0 : t.U, n);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int n = t.xwords[k] ? words : 0;
    copy_granule<VEC>(&sh.b[t.row + 16 * k][4 * t.cg],
                      n ? t.b[k] + c0 : t.b[k], n);
  }
  if (p > 0) load_chunk<VEC>(sh, t, p, 0);
  commit();
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    trsm_diag_kernel(const float* __restrict__ U, const float* __restrict__ B,
                     float* __restrict__ X, int m, int nb, long long su,
                     long long ldu, long long sb, long long ldb, long long sx,
                     long long ldx) {
  extern __shared__ __align__(16) float smem[];
  Shared& sh = *reinterpret_cast<Shared*>(smem);
  const long long z = blockIdx.z;
  U += z * su;
  B += z * sb;
  X += z * sx;
  const int r0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  Roles t;
  t.U = U;
  t.ldu = ldu;
  t.nb = nb;
  t.row = tid >> 3;
  t.cg = tid & 7;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = r0 + t.row + 16 * k;
    t.xwords[k] = r < m ? 4 : 0;
    t.x[k] = r < m ? X + r * ldx + 4 * t.cg : X;
    t.b[k] = r < m ? B + r * ldb + 4 * t.cg : B;
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) t.u[k] = U + (t.row + 16 * k) * ldu + 4 * t.cg;
  const int tx = tid & 7;   // columns 4 tx .. 4 tx + 3 of the panel
  const int ty = tid >> 3;  // rows ty + 16 i of the strip
  const int panels = (nb + W - 1) / W;

  load_head<VEC>(sh, t, 0);
  for (int p = 0; p < panels; ++p) {
    const int c0 = W * p;
    const int w = min(W, nb - c0);
    // 1. acc = B - X[:, :c0] U[:c0, panel], chunk by chunk; the head (group
    // of chunk 0) is in flight, chunks 1 .. STAGES - 2 go now, one empty
    // group for each that does not exist, so the counts stay uniform
    for (int q = 1; q < STAGES - 1; ++q) {
      if (q < p) load_chunk<VEC>(sh, t, p, q);
      commit();
    }
    float acc[4][4];
    if (p == 0) {
      wait_groups<0>();
      __syncthreads();
    }
    for (int q = 0; q < max(p, 1); ++q) {
      if (p > 0) {
        if (q + STAGES - 1 < p) load_chunk<VEC>(sh, t, p, q + STAGES - 1);
        commit();
        wait_groups<STAGES - 1>();
        __syncthreads();
      }
      if (q == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 v =
              *reinterpret_cast<const float4*>(&sh.b[ty + 16 * i][4 * tx]);
          acc[i][0] = v.x;
          acc[i][1] = v.y;
          acc[i][2] = v.z;
          acc[i][3] = v.w;
        }
      }
      if (p == 0) break;
      const Stage& st = sh.ring[q % STAGES];
      const float(*xs)[XS] = q + 1 < p ? st.x : sh.s[(p - 1) & 1];
#pragma unroll
      for (int kk = 0; kk < W; kk += 4) {
        float4 xv[4], uv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          xv[i] = *reinterpret_cast<const float4*>(&xs[ty + 16 * i][kk]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          uv[j] = *reinterpret_cast<const float4*>(&st.u[kk + j][4 * tx]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[i][c] = fmaf(-part(xv[i], j), part(uv[j], c), acc[i][c]);
      }
      __syncthreads();
    }
    if (p == 0) __syncthreads();  // everyone has read sh.b
    // the ring and sh.b are free: the next panel's head loads under the solve
    if (p + 1 < panels) load_head<VEC>(sh, t, p + 1);

    // 2. solve against the diagonal tile, a thread a row
    float(*xp)[XS] = sh.s[p & 1];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(&xp[ty + 16 * i][4 * tx]) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    const float(*d)[W] = sh.d[p & 1];
    if (tid < W) sh.rinv[tid] = tid < w ? 1.f / d[tid][tid] : 0.f;
    __syncthreads();
    if (tid < BM) {
      float a[W];
#pragma unroll
      for (int c = 0; c < W; c += 4) {
        const float4 v = *reinterpret_cast<const float4*>(&xp[tid][c]);
        a[c] = v.x;
        a[c + 1] = v.y;
        a[c + 2] = v.z;
        a[c + 3] = v.w;
      }
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const float xk = a[k] * sh.rinv[k];
        a[k] = xk;
#pragma unroll
        for (int gr = (k + 1) / 4; gr < W / 4; ++gr) {
          const float4 v = *reinterpret_cast<const float4*>(&d[k][4 * gr]);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (4 * gr + e > k)
              a[4 * gr + e] = fmaf(-xk, part(v, e), a[4 * gr + e]);
        }
      }
#pragma unroll
      for (int c = 0; c < W; c += 4)
        *reinterpret_cast<float4*>(&xp[tid][c]) =
            make_float4(a[c], a[c + 1], a[c + 2], a[c + 3]);
    }
    __syncthreads();

    // 3. X[:, panel] out; the next panel reads it from sh.s, later ones
    // from global memory (their loads start two panels on, after barriers)
    for (int e = tid; e < BM * W; e += THREADS) {
      const int r = e >> 5, c = e & 31;
      if (r0 + r < m && c < w) X[(r0 + r) * ldx + c0 + c] = xp[r][c];
    }
  }
}

constexpr int MAX_DEVICES = 64;

// Raises the kernel's shared-memory limit above the 48 KB default, once per
// device (the call costs host time on every launch otherwise).
template <bool VEC>
cudaError_t allow_smem() {
  static std::atomic<bool> done[MAX_DEVICES];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < MAX_DEVICES && done[device].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(trsm_diag_kernel<VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sizeof(Shared)));
  if (err == cudaSuccess && device < MAX_DEVICES) done[device].store(true);
  return err;
}

}  // namespace

extern "C" cudaError_t repro_trsm_diag(const float* u, const float* b,
                                       float* x, int batch, int m, int nb,
                                       long long su, long long ldu,
                                       long long sb, long long ldb,
                                       long long sx, long long ldx,
                                       cudaStream_t stream) {
  if (m < 1 || nb < 1) return cudaErrorInvalidValue;
  // 16-byte copies when every row (and batch) start is 16-byte aligned
  const bool vec =
      ((reinterpret_cast<uintptr_t>(u) | reinterpret_cast<uintptr_t>(b) |
        reinterpret_cast<uintptr_t>(x)) & 15) == 0 &&
      ((su | ldu | sb | ldb | sx | ldx) & 3) == 0;
  const cudaError_t err = vec ? allow_smem<true>() : allow_smem<false>();
  if (err != cudaSuccess) return err;
  auto kernel = vec ? trsm_diag_kernel<true> : trsm_diag_kernel<false>;
  const size_t smem = sizeof(Shared);
  const dim3 grid((m + BM - 1) / BM, 1, batch);
  kernel<<<grid, THREADS, smem, stream>>>(u, b, x, m, nb, su, ldu, sb, ldb,
                                          sx, ldx);
  return cudaSuccess;
}
