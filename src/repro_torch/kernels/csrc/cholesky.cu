// K3: Cholesky factor of one SPD block, L L^T = A (nb x nb, fp32), for
// nb <= 336.
//
// Replaces the reference package's Pallas kernel
// (src/repro/kernels/cholesky/cholesky.py, cholesky_block_pallas): nb steps
// of square-root pivot, column scale and rank-1 update of the trailing
// matrix in fp32, then the upper triangle zeroed.  The blocked wrapper
// (kernels/cholesky/ops.py) sends panel solves to K2 and trailing updates
// to K1, and factors a block wider than 336 columns by the same composition
// (K3 on 256-wide diagonal blocks, K2, K1), so this kernel only ever
// factors one block that fits a CTA.
//
// What bounds it: nb^3/3 operations on 2*nb^2 elements (at nb = 256 about
// 5.6 Mflop on 384 KB), all on one SM, so neither the card's bytes nor its
// operations: one SM's FFMA rate (about 0.5 TFLOP/s, 11 us at nb = 256)
// and the dependent chain of nb pivots.
//
// What the design does about it: one CTA of 512 threads per block
// (batched blocks on blockIdx.z run side by side), the packed lower
// triangle in shared memory (230 KB at nb = 336), factored right-looking by
// panels of 32 columns (the last may be narrower):
//   1. one warp factors the 32 x 32 diagonal tile in registers, a lane a
//      row: the pivot's chain is one shuffle, rsqrt and two FMAs a step,
//      the column reaches the other lanes through shared memory as float4,
//      and no block barrier is on the chain;
//   2. the rows below solve against the tile, a thread a row, the row in
//      registers and the tile's rows broadcast from shared memory as float4;
//   3. the trailing lower triangle takes the panel's 32 rank-1 updates in a
//      register-tiled syrk: a warp owns a 16 x 32 patch, a lane 4 x 4 of it,
//      and each float4 it loads feeds 4 FFMAs (16 per 8 loads); patches
//      wholly above the diagonal are skipped.
// Warp 0 runs ahead (look-ahead): it solves the next tile's 32 rows, hands
// them over through a named barrier without waiting, updates the next tile
// and factors it while the other warps solve the remaining rows and update
// the rest of the triangle.  The update runs on the 12 warps outside warp
// 0's SM partition, so that nothing competes with its chain for issue.
// Two barriers a panel (one of them named), 15 block-wide at nb = 256.
// The triangle is stored by float4 granules: rows in groups of four (row
// i padded to (i | 3) + 1 columns), a group's rows interleaved granule by
// granule, one spare granule after each group.  That puts the rows that a
// warp's lanes read at once (up to 8 groups apart) in distinct bank groups,
// so the syrk's float4 loads are free of bank conflicts.  Every update is
// applied in the reference's order (ascending pivot, one FMA each); only
// the pivot's reciprocal square root (rsqrt refined by one Newton step,
// about 1 ulp) differs from the reference's square root and division.
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "kernels.h"

namespace {

constexpr int W = 32;  // panel width: one warp's diagonal tile
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int SYRK_WARPS = WARPS - WARPS / 4;  // all but warp 0's partition
// widest block whose granule-packed triangle fits the 227 KB of a CTA
constexpr int ONE_CTA_MAX = 336;
constexpr unsigned FULL = 0xffffffffu;

// float4 index of columns 4g .. 4g + 3 of row i (see the note above)
__host__ __device__ __forceinline__ int granule(int i, int g) {
  const int q = i >> 2;
  return 2 * q * (q + 1) + q + 4 * g + (i & 3);
}

__device__ __forceinline__ float part(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// 16-byte cp.async of words (0..4) of src into dst, zero-filling the rest;
// src 16-byte aligned
__device__ __forceinline__ void copy_granule(float4* dst, const float* src,
                                             int words) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
               "l"(src), "r"(4 * words));
}

// 4-byte cp.async; zero-fills the word when !valid (src is then not read)
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           bool valid) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr),
               "l"(src), "r"(valid ? 4 : 0));
}

// Step 1: warp-local factor of the diagonal tile at (c0, c0); lanes whose
// row lies beyond nb act as identity rows and store nothing.  Writes the
// reciprocal pivots to rinv for the panel solve.  Each column goes to the
// other lanes through cols (2 x W floats, by step parity; one __syncwarp a
// step) and is read back as float4.
__device__ __forceinline__ void factor_tile(float4* tri, float* rinv,
                                            float* cols, int c0, int nb,
                                            int lane) {
  const int i = c0 + lane;
  const bool live = i < nb;
  const int g0 = c0 >> 2;
  float a[W];
#pragma unroll
  for (int m = 0; m < W / 4; ++m) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live && 4 * m <= lane) v = tri[granule(i, g0 + m)];
    a[4 * m] = v.x;
    a[4 * m + 1] = v.y;
    a[4 * m + 2] = v.z;
    a[4 * m + 3] = v.w;
  }
#pragma unroll
  for (int j = 0; j < W; ++j)
    if (j > lane || !live) a[j] = j == lane ? 1.f : 0.f;

  // the chain: pivot -> 1/sqrt (rsqrt and one Newton step, about 1 ulp)
  // -> column -> the next pivot, which lane k + 1 updates and broadcasts
  // before the rest of the rank-1 update
  float piv = __shfl_sync(FULL, a[0], 0);
#pragma unroll
  for (int k = 0; k < W; ++k) {
    float inv = rsqrtf(piv);
    inv *= fmaf(-0.5f * piv * inv, inv, 1.5f);
    const float l = a[k] * inv;  // column k of L on lanes >= k, else 0
    if (lane >= k) a[k] = l;
    if (lane == k) rinv[k] = inv;
    float* col = cols + W * (k & 1);
    col[lane] = l;
    if (k + 1 < W) piv = __shfl_sync(FULL, fmaf(-l, l, a[k + 1]), k + 1);
    __syncwarp();
#pragma unroll
    for (int m = (k + 1) / 4; m < W / 4; ++m) {
      const float4 v = reinterpret_cast<const float4*>(col)[m];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * m + e;
        if (j > k && lane >= j) a[j] = fmaf(-l, part(v, e), a[j]);
      }
    }
  }

  if (live) {
#pragma unroll
    for (int m = 0; m < W / 4; ++m)
      if (4 * m <= lane)
        tri[granule(i, g0 + m)] = make_float4(a[4 * m], a[4 * m + 1],
                                              a[4 * m + 2], a[4 * m + 3]);
  }
}

// Step 2: row i's 32 panel entries against the factored tile, in place:
// x_k = (a_k - sum_{j<k} x_j L[k][j]) / L[k][k], the sum in ascending j.
__device__ __forceinline__ void solve_row(float4* tri, const float* rinv,
                                          int c0, int i) {
  const int g0 = c0 >> 2;
  float x[W];
#pragma unroll
  for (int m = 0; m < W / 4; ++m) {
    const float4 v = tri[granule(i, g0 + m)];
    x[4 * m] = v.x;
    x[4 * m + 1] = v.y;
    x[4 * m + 2] = v.z;
    x[4 * m + 3] = v.w;
  }
#pragma unroll
  for (int k = 0; k < W; ++k) {
    float s = x[k];
#pragma unroll
    for (int m = 0; 4 * m < k; ++m) {
      const float4 v = tri[granule(c0 + k, g0 + m)];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * m + e < k) s = fmaf(-x[4 * m + e], part(v, e), s);
    }
    x[k] = s * rinv[k];
  }
#pragma unroll
  for (int m = 0; m < W / 4; ++m)
    tri[granule(i, g0 + m)] =
        make_float4(x[4 * m], x[4 * m + 1], x[4 * m + 2], x[4 * m + 3]);
}

// Step 3 for one 16 x 32 patch (band PI of row groups, band PJ of column
// granules, counted from c1): lane (ly, lx) owns row group
// c1/4 + 4 PI + ly against column granule c1/4 + 8 PJ + lx, and applies the
// panel's 32 rank-1 terms in ascending order.
__device__ __forceinline__ void update_patch(float4* tri, int c0, int c1,
                                             int groups, int pi, int pj,
                                             int lane) {
  const int qi = (c1 >> 2) + 4 * pi + (lane >> 3);
  const int gj = (c1 >> 2) + 8 * pj + (lane & 7);
  if (qi >= groups || gj > qi) return;
  const int g0 = c0 >> 2;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float4 v = tri[granule(4 * qi + a, gj)];
    acc[a][0] = v.x;
    acc[a][1] = v.y;
    acc[a][2] = v.z;
    acc[a][3] = v.w;
  }
#pragma unroll
  for (int m = 0; m < W / 4; ++m) {
    float4 li[4], lj[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) li[a] = tri[granule(4 * qi + a, g0 + m)];
#pragma unroll
    for (int b = 0; b < 4; ++b) lj[b] = tri[granule(4 * gj + b, g0 + m)];
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          acc[a][b] = fmaf(-part(li[a], e), part(lj[b], e), acc[a][b]);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
    tri[granule(4 * qi + a, gj)] =
        make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
}

// VEC: A and L rows (and batch strides) 16-byte aligned, so the triangle
// comes in by 16-byte copies and goes out by float4 stores
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
    cholesky_block_kernel(const float* __restrict__ A, float* __restrict__ L,
                          int nb, long long sa, long long lda, long long sl,
                          long long ldl) {
  extern __shared__ float4 smem[];
  float* rinv = reinterpret_cast<float*>(smem);  // 2 x W floats, by parity
  float* cols = rinv + 2 * W;                    // 2 x W floats
  float4* tri = smem + W;
  const long long z = blockIdx.z;
  A += z * sa;
  L += z * sl;
  const int nbp = (nb + 3) & ~3;  // rows nb .. nbp - 1 are identity rows
  const int groups = nbp >> 2;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // the lower triangle by cp.async, a granule at a time, all in flight at
  // once; the words above the diagonal are zero-filled, not read.  Rows
  // nb .. nbp - 1 are identity rows.
  for (int i = warp; i < nbp; i += WARPS) {
    const float* src = A + i * lda;
    for (int g = lane; g <= (i >> 2); g += 32) {
      float4* dst = tri + granule(i, g);
      const int words = min(4, i + 1 - 4 * g);
      if (i >= nb) {
        const int e = i - 4 * g;
        *dst = make_float4(e == 0, e == 1, e == 2, e == 3);
      } else if (VEC) {
        copy_granule(dst, src + 4 * g, words);
      } else {
        float* d = reinterpret_cast<float*>(dst);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          copy_async(d + e, e < words ? src + 4 * g + e : src, e < words);
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  if (warp == 0) factor_tile(tri, rinv, cols, 0, nb, lane);
  __syncthreads();

  for (int c0 = 0; c0 + W < nb; c0 += W) {
    const int c1 = c0 + W;
    const float* r = rinv + W * ((c0 / W) & 1);
    // patches in order: band pi holds pj = 0 .. pi / 2; indices 0 and 1,
    // (0, 0) and (1, 0), cover the next diagonal tile
    const int bands = (groups - (c1 >> 2) + 3) >> 2;
    if (warp == 0) {
      // look-ahead: the next tile's rows, its update and its factor, with
      // no wait for the other warps (barrier 1 only hands the rows over)
      if (c1 + lane < nbp) solve_row(tri, r, c0, c1 + lane);
      __syncwarp();
      asm volatile("bar.arrive 1, %0;\n" ::"n"(THREADS));
      update_patch(tri, c0, c1, groups, 0, 0, lane);
      if (bands > 1) update_patch(tri, c0, c1, groups, 1, 0, lane);
      __syncwarp();
      factor_tile(tri, rinv + W * ((c1 / W) & 1), cols, c1, nb, lane);
    } else {
      for (int i = c1 + W + tid - 32; i < nbp; i += THREADS - 32)
        solve_row(tri, r, c0, i);
      asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS));
      // the rest of the update, on the 12 warps outside warp 0's SM
      // partition (warp % 4 names it), so that nothing competes with its
      // chain
      const int worker = (warp & 3) ? warp - (warp >> 2) - 1 : -1;
      int idx = 0;
      for (int pi = 0; pi < bands; ++pi)
        for (int pj = 0; pj <= (pi >> 1); ++pj, ++idx)
          if (idx >= 2 && (idx - 2) % SYRK_WARPS == worker)
            update_patch(tri, c0, c1, groups, pi, pj, lane);
    }
    __syncthreads();
  }

  for (int i = warp; i < nb; i += WARPS) {
    float* dst = L + i * ldl;
    for (int g = lane; 4 * g < nb; g += 32) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (g <= (i >> 2)) {
        v = tri[granule(i, g)];
        const int e = i - 4 * g;  // zero what lies above the diagonal
        if (e < 3) v.w = 0.f;
        if (e < 2) v.z = 0.f;
        if (e < 1) v.y = 0.f;
      }
      if (VEC && 4 * g + 4 <= nb) {
        *reinterpret_cast<float4*>(dst + 4 * g) = v;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * g + e < nb) dst[4 * g + e] = part(v, e);
      }
    }
  }
}

constexpr int MAX_DEVICES = 64;

// Raises the kernel's shared-memory limit to what the widest block needs,
// once per device (the call costs host time on every launch otherwise).
template <bool VEC>
cudaError_t allow_smem() {
  static std::atomic<bool> done[MAX_DEVICES];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < MAX_DEVICES && done[device].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(
      cholesky_block_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(float4) *
                       (W + granule((ONE_CTA_MAX + 3) & ~3, 0))));
  if (err == cudaSuccess && device < MAX_DEVICES) done[device].store(true);
  return err;
}

}  // namespace

extern "C" cudaError_t repro_cholesky_block(const float* a, float* l,
                                            int batch, int nb, long long sa,
                                            long long lda, long long sl,
                                            long long ldl,
                                            cudaStream_t stream) {
  if (nb < 1 || nb > ONE_CTA_MAX) return cudaErrorInvalidValue;
  const bool vec =
      ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(l)) &
       15) == 0 &&
      ((sa | lda | sl | ldl) & 3) == 0;
  const cudaError_t err = vec ? allow_smem<true>() : allow_smem<false>();
  if (err != cudaSuccess) return err;
  const int nbp = (nb + 3) & ~3;
  const size_t smem = sizeof(float4) * (W + granule(nbp, 0));
  auto kernel =
      vec ? cholesky_block_kernel<true> : cholesky_block_kernel<false>;
  kernel<<<dim3(1, 1, batch), THREADS, smem, stream>>>(a, l, nb, sa, lda, sl,
                                                        ldl);
  return cudaSuccess;
}
