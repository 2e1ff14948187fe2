// K1: blocked matrix product C = A @ B: fp32 inputs on the CUDA cores (this
// file and matmul_f32.cuh), bf16 inputs on the tensor cores (matmul_bf16.cu).
//
// Replaces the reference package's MXU-tiled Pallas kernel
// (src/repro/kernels/matmul/matmul.py, matmul_pallas): the same function --
// (M,K) x (K,N), fp32 accumulation, the result written once in the output
// type -- thought through again for Hopper rather than carried over block by
// block.  The TPU kernel's plan tiles (bm/bn/bk) are a VMEM decision;
// here a plan picks one of a few compiled CTA tiles (below).
//
// What bounds it: at every fp32 product the linalg path launches, 2*M*N*K
// operations on M*K + K*N + M*N elements sit far above the card's balance
// of operations to bytes, so the bound is IEEE fp32 FFMA at 67 TFLOP/s (no
// TF32: the dispatch gates need relative error < 1e-4; wgmma has no IEEE
// fp32 type).  At 16384^3 the bytes are 0.5 % of the bound.  The trailing
// updates of the blocked trsm and Cholesky have K = 256: there C's write
// (4 bytes an element after 512 operations) is 16 % of the bound, and each
// 128x128 tile of C goes out after only 256 k-steps.
//
// Inside an SM the limit is the operand traffic from shared memory to the
// registers, not the FFMA pipes: the earlier body's 8x8 thread tile (two
// float4 reads of A and two of B per 64 FFMAs) ran at 59 % of the bound
// (PERF.md), and so did an 8x8 tile fed by cp.async.  What the fp32 body
// (matmul_f32_kernel) does about it:
//  - Each thread keeps an 8x16 tile of C in registers: per k, 128 FFMAs on
//    two float4 reads of B's row and half a float4 read of A (four k at a
//    time): 6 shared loads per 128 FFMAs.  A CTA of 128 threads owns a
//    128x128 tile of C, a warp 64x64; 255 registers, no spills.
//  - Two CTAs an SM (__launch_bounds__(128, 2), 103 KB of shared memory
//    each), so one CTA's prologue and epilogue overlap the other's
//    products: at K = 256 a CTA is 8 stages long.
//  - A ring of 3 stages of BK = 32 in dynamic shared memory, one barrier a
//    stage.  Where A's and B's rows are 16-byte aligned, one thread fills a
//    stage with two TMA boxes that complete on the stage's mbarrier: no
//    copy instruction in the other threads (16-byte cp.async copies by
//    every thread measured slower on the card).  A's box arrives in the
//    128-byte swizzle, so a warp's float4 reads over k from 8 consecutive
//    rows hit 8 distinct bank groups; B's rows are read as consecutive
//    granules.  TMA zero-fills the ragged edges.
//  - Elsewhere (rows not 16-byte aligned, as at 130 columns) each thread
//    copies its granules by 4-byte cp.async, masked and zero-filled only
//    where a stage crosses an edge, A's rows padded to BK + 4 floats for
//    the same conflict-free reads.
//  - The epilogue writes float4s where C's rows are 16-byte aligned and
//    masked scalars on the ragged edge.
//  - Tiles run in groups of 16 tile rows, column by column inside a group,
//    so the CTAs resident at one time share strips of A and B in L2.  The
//    batch (the stacked ranks of a process grid) runs on blockIdx.z, with
//    64-bit offsets.
// Each element of C sums its products in ascending k, one FFMA each.
//
// The CTA tile is a template parameter (Tile, in matmul_f32.cuh, which holds
// the body); the bullets above describe the default, 128x128, which every
// path that passes no plan or the heuristic one runs.  Five more tiles are compiled, 64x64, 64x128,
// 128x64, 256x64 and 256x128, each with its own thread tile (8x16 or 8x8),
// ring depth (3 or 4 stages) and CTAs an SM; the wrapper maps a plan's
// (bm, bn) onto one (kernels/matmul/ops.py, cta_tile).  The order of the
// sums does not depend on the tile, so every tile gives the same bits.
// Each tile is its own translation unit (matmul_tile_<BM>x<BN>.cu), so that
// the build compiles them in parallel; this file holds the entry points.
//
// bf16 inputs run the bf16 body on the tensor cores (matmul_bf16.cu:
// wgmma on TMA tiles of 128 x 256), which repro_torch.linalg.matmul reaches
// whenever its operands are bf16 (the dispatch hands every local product
// to K1 in the operands' type).  It is the one bf16 body: operands whose
// rows or batch starts TMA cannot load are staged by the wrapper into
// aligned buffers first, and K = 0 never reaches the launcher
// (kernels/matmul/ops.py).
#include <cuda_runtime.h>

#include "kernels.h"
#include "matmul_f32.cuh"

namespace {

// the only CTA tile a bf16 launch may request (the default)
constexpr int BM = 128;
constexpr int BN = 128;

}  // namespace

extern "C" cudaError_t repro_matmul(const void* a, const void* b, void* c,
                                    int in_type, int out_type, int batch,
                                    int m, int n, int k, long long sa,
                                    long long lda, long long sb,
                                    long long ldb, long long sc,
                                    long long ldc, int tile_m, int tile_n,
                                    int* body, cudaStream_t stream) {
  const bool known = (in_type == REPRO_F32 || in_type == REPRO_BF16) &&
                     (out_type == REPRO_F32 || out_type == REPRO_BF16);
  if (!known || batch < 1 || batch > 65535 || m < 1 || n < 1 || k < 0)
    return cudaErrorInvalidValue;
  const repro_k1::Call call{a,  b,   c,  out_type, batch, m,  n,     k,
                            sa, lda, sb, ldb,      sc,    ldc, stream};
  if (in_type == REPRO_BF16) {
    // bf16 takes no plan: the default tile request alone
    if (tile_m != BM || tile_n != BN) return cudaErrorInvalidValue;
    const cudaError_t err = repro_k1::run_bf16(call);
    if (err == cudaSuccess) *body = REPRO_K1_BF16_TC;
    return err;
  }
  const cudaError_t err = repro_k1::with_tile(tile_m, tile_n, [&](auto cta) {
    using C = decltype(cta);
    return repro_k1::run_at<C::BM, C::BN>(call);
  });
  if (err == cudaSuccess) *body = REPRO_K1_F32;
  return err;
}

extern "C" cudaError_t repro_matmul_info(int tile_m, int tile_n,
                                         long long* out) {
  return repro_k1::with_tile(tile_m, tile_n, [&](auto cta) {
    using C = decltype(cta);
    return repro_k1::info_at<C::BM, C::BN>(out);
  });
}
