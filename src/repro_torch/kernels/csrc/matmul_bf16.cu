// K1's bf16 body: C = A B for bf16 A and B on the tensor cores (wgmma),
// the tiles loaded by the Tensor Memory Accelerator (TMA), fp32 sums, C
// written once in bf16 or fp32.
//
// The same function as the fp32 body (matmul.cu says what K1 replaces: the
// reference's matmul_pallas, whose design type is bf16), at the rate bf16
// operands allow.  What bounds it: at 4096^3 the product is 2 n^3 = 137
// GFLOP on 3 x 32 MB (bf16 in, fp32 out), far above the card's balance of
// operations to bytes, so the bound is the tensor cores' 989 TFLOP/s
// (0.139 ms).  An FFMA body that widened bf16 to fp32 on load ran at 3 %
// of that bound; the tensor cores are the one way to it, and this is K1's
// one bf16 body.
//
// What the design does about it:
//  - One CTA owns a 128 x 256 tile of C: two consumer warpgroups of 64
//    rows, each one wgmma m64n256k16 chain whose fp32 accumulator is 128
//    registers a thread, and one producer warp.  A CTA an SM (196 KB of
//    shared memory, 288 threads of at most 224 registers).
//  - The producer's one lane keeps a ring of 4 stages of BK = 64 (128
//    bytes of bf16, one swizzle row) filled: a stage is A's 128 x 64 box
//    and four 64 x 64 boxes of B, 48 KB, which complete on the stage's
//    "full" mbarrier.  The consumers free a stage on its "empty" mbarrier
//    (one arrival a warp) once its products are done, as K4's tensor-core
//    body does.
//  - Both operands stay where they are in device memory.  A (M, K) is
//    K-major; B (K, N) row-major is MN-major, which wgmma reads for 16-bit
//    types through its transpose-B immediate, so B is not copied: its four
//    64-column panels sit 8 KB apart (the descriptor's leading byte
//    offset), 8-row groups 1024 bytes apart (its stride byte offset).  The
//    TMA's 128-byte swizzle is the layout wgmma reads without bank
//    conflicts.
//  - Each consumer issues a stage's four products as one group and waits
//    for the previous group only (wgmma.wait_group 1), so the tensor cores
//    always hold the next stage's products while a stage is freed.
//  - TMA zero-fills the ragged edges of M, N and K, so every stage is a
//    whole one.  It needs A's and B's starts 16-byte aligned and their row
//    and batch strides multiples of 8 elements.  The wrapper stages an
//    operand that is not so (K or N not a multiple of 8, a view at an odd
//    column) into a buffer whose rows are rounded up to 8 elements
//    (kernels/matmul/ops.py, tma_staged): O(MK + KN) bytes against the
//    product's O(MNK) work, and the map's extents stay the logical K and
//    N, so the padding is never read as data.  Given such an operand all
//    the same, the launcher returns cudaErrorMisalignedAddress, which the
//    binding raises; K = 0 is refused (the wrapper returns zeros itself).
//  - The epilogue converts the fp32 accumulators once, to bf16 or fp32,
//    and stores each thread's column pairs straight from registers: a
//    warp's store covers 8 rows x 8 columns, whole 32-byte sectors of fp32
//    (16 bytes of bf16); masked scalars on the ragged edges.
//  - Tiles run in groups of 16 tile rows, column by column inside a group,
//    as in the fp32 body, so the CTAs resident at one time share strips of
//    A and B in L2; the batch runs on blockIdx.z with 64-bit offsets.
// The plan does not reach this body: bf16 inputs take the default tile
// request whatever the plan (kernels/matmul/ops.py).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstdint>

#include "hopper.cuh"
#include "matmul_f32.cuh"

namespace repro_k1 {

namespace {

namespace tc {

using namespace repro_hopper;

constexpr int BM = 128;                 // rows of C: two warpgroups of 64
constexpr int BN = 256;                 // columns of C: one m64n256 each
constexpr int BK = 64;                  // k a stage: one 128-byte row
constexpr int STAGES = 4;
constexpr int CONSUMERS = 256;          // the two warpgroups' threads
constexpr int THREADS = CONSUMERS + 32; // and one producer warp
constexpr int PANEL = 64;               // bf16 columns of a 128-byte row
constexpr int ROW_BYTES = 128;
constexpr int GROUP = 16;               // tile rows of a group of tiles
constexpr int MAX_DEVICES = 64;
constexpr int A_BYTES = BM * ROW_BYTES;                  // 16 KB
constexpr int PANEL_BYTES = BK * ROW_BYTES;              // 8 KB
constexpr int STAGE_BYTES = A_BYTES + (BN / PANEL) * PANEL_BYTES;
constexpr int BAR_OFFSET = STAGES * STAGE_BYTES;
// the ring, its full and empty mbarriers, slack to align the base
constexpr int SMEM_BYTES = BAR_OFFSET + 16 * STAGES + 1024;

static_assert(BK * 2 == ROW_BYTES && BN % PANEL == 0,
              "a stage's rows are whole 128-byte swizzle rows");
static_assert(A_BYTES % 1024 == 0 && PANEL_BYTES % 1024 == 0 &&
                  STAGE_BYTES % 1024 == 0,
              "every box starts on a 1024-byte swizzle atom");
static_assert(SMEM_BYTES <= 232448, "a CTA takes at most 227 KB");

// D(64 x 256) += A(64 x 16) B(16 x 256) on the tensor cores, fp32 sums: A
// K-major, B MN-major (the transpose-B immediate), both in shared memory.
__device__ __forceinline__ void wgmma_m64n256(float* d, uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// Writes v0, v1 to p[0], p[1], as many as lie inside C (avail): one pair
// store where C's pairs are aligned, else masked scalars.
template <typename TO>
__device__ __forceinline__ void store_pair(TO* p, float v0, float v1,
                                           int avail, bool vec_c) {
  if (vec_c && avail >= 2) {
    if constexpr (sizeof(TO) == 4)
      *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
    else
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
    return;
  }
  if (avail >= 1) put(p, v0);
  if (avail >= 2) put(p + 1, v1);
}

// C[z] = A[z] B[z] from the maps ta (K, M, batch) and tb (N, K, batch) at
// batch coordinate z, or 0 for an operand shared by the batch.  The
// thread's rows are r0 and r0 + 8 of its warp's 16; in the accumulator of
// an m64nN product, register i holds row r0 + 8 * ((i >> 1) & 1) and
// column 8 * (i >> 2) + 2 * (lane % 4) + (i & 1).
template <typename TO>
__global__ void __launch_bounds__(THREADS, 1)
    matmul_bf16_kernel(const __grid_constant__ CUtensorMap ta,
                       const __grid_constant__ CUtensorMap tb,
                       TO* __restrict__ C, int M, int N, int K,
                       bool shared_a, bool shared_b, long long sc,
                       long long ldc, bool vec_c) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = base + BAR_OFFSET;     // [STAGES]
  const uint32_t empty = full + 8 * STAGES;    // [STAGES]
  const int z = blockIdx.z;

  // grouped tile order: GROUP tile rows, column by column
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles_m = (M + BM - 1) / BM;
  const int per_group = GROUP * tiles_n;
  const int first = blockIdx.x / per_group * GROUP;
  const int rows = min(tiles_m - first, GROUP);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first + in_group % rows) * BM;
  const int n0 = in_group / rows * BN;
  const int steps = (K + BK - 1) / BK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS / 32);   // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // the producer warp: one lane issues every load
    if (tid == CONSUMERS) {
      const int za = shared_a ? 0 : z, zb = shared_b ? 0 : z;
      for (int t = 0; t < steps; ++t) {
        const int s = t % STAGES;
        const uint32_t stage = base + s * STAGE_BYTES;
        if (t >= STAGES)   // the step that used this stage is done
          mbar_wait(empty + 8 * s, ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, STAGE_BYTES);
        tma_load(stage, &ta, full + 8 * s, t * BK, m0, za);
#pragma unroll
        for (int p = 0; p < BN / PANEL; ++p)
          tma_load(stage + A_BYTES + p * PANEL_BYTES, &tb, full + 8 * s,
                   n0 + p * PANEL, t * BK, zb);
      }
    }
    return;
  }

  // a consumer warpgroup: 64 rows of the tile
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const uint32_t a_rows = wg * 64 * ROW_BYTES;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  for (int t = 0; t < steps; ++t) {
    const int s = t % STAGES;
    const uint32_t stage = base + s * STAGE_BYTES;
    mbar_wait(full + 8 * s, (t / STAGES) & 1);
    fence_regs<128>(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64n256(acc, desc(stage + a_rows + kk * 32, 16, 1024),
                    desc(stage + A_BYTES + kk * 16 * ROW_BYTES, PANEL_BYTES,
                         1024));
    wg_commit();
    wg_wait<1>();   // step t - 1's products are done ...
    fence_regs<128>(acc);
    if (t > 0 && lane == 0)   // ... so its stage is free
      mbar_arrive(empty + 8 * ((t - 1) % STAGES));
  }
  wg_wait<0>();
  fence_regs<128>(acc);

  const int r0 = m0 + wg * 64 + warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  C += z * sc;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= M) continue;
    TO* c_row = C + row * ldc;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + cq;
      store_pair(c_row + col, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1],
                 N - col, vec_c);
    }
  }
}

// Raises the kernel's shared-memory limit above the 48 KB default, once
// per device: the call costs host time on every launch otherwise.
template <typename TO>
cudaError_t allow_smem() {
  static std::atomic<bool> done[MAX_DEVICES];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < MAX_DEVICES && done[device].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(matmul_bf16_kernel<TO>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (err == cudaSuccess && device < MAX_DEVICES) done[device].store(true);
  return err;
}

// The TMA map of one bf16 operand of (cols, rows, batch) elements with row
// and batch strides in elements (a batch stride of 0: one matrix for the
// whole batch), boxes of 64 columns by box_rows rows in the 128-byte
// swizzle, zeros outside.  The caller has checked that the operand is
// 16-byte aligned with strides in multiples of 8 elements.
bool tensor_map(CUtensorMap* map, const void* ptr, int cols, int rows,
                int batch, long long ld, long long stride, int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  // the stride of an axis of extent 1 is never read: the extent below it
  const long long row = rows > 1 ? ld : (cols + 7LL) / 8 * 8;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(stride ? batch : 1)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(row) * 2,
      static_cast<cuuint64_t>(stride && batch > 1 ? stride : rows * row) * 2};
  const cuuint32_t box[3] = {PANEL, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TO>
cudaError_t launch(const CUtensorMap& ta, const CUtensorMap& tb,
                   const Call& c, int tiles) {
  const cudaError_t err = allow_smem<TO>();
  if (err != cudaSuccess) return err;
  TO* out = static_cast<TO*>(c.c);
  const bool vec_c =
      reinterpret_cast<uintptr_t>(out) % (2 * sizeof(TO)) == 0 &&
      ((c.sc | c.ldc) & 1) == 0;
  matmul_bf16_kernel<TO>
      <<<dim3(tiles, 1, c.batch), THREADS, SMEM_BYTES, c.stream>>>(
          ta, tb, out, c.m, c.n, c.k, c.sa == 0, c.sb == 0, c.sc, c.ldc,
          vec_c);
  return cudaSuccess;
}

}  // namespace tc

}  // namespace

cudaError_t run_bf16(const Call& c) {
  const long long tiles =
      static_cast<long long>((c.m + tc::BM - 1) / tc::BM) *
      ((c.n + tc::BN - 1) / tc::BN);
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  if (c.k < 1) return cudaErrorInvalidValue;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(c.a) | reinterpret_cast<uintptr_t>(c.b)) &
       15) == 0 &&
      ((c.sa | c.lda | c.sb | c.ldb) & 7) == 0;
  CUtensorMap ta{}, tb{};
  if (!aligned ||
      !tc::tensor_map(&ta, c.a, c.k, c.m, c.batch, c.lda, c.sa, tc::BM) ||
      !tc::tensor_map(&tb, c.b, c.n, c.k, c.batch, c.ldb, c.sb, tc::BK))
    return cudaErrorMisalignedAddress;
  if (c.out_type == REPRO_F32)
    return tc::launch<float>(ta, tb, c, static_cast<int>(tiles));
  return tc::launch<__nv_bfloat16>(ta, tb, c, static_cast<int>(tiles));
}

}  // namespace repro_k1
