// Python binding of the kernel launchers: the one source that includes
// PyTorch's headers.  Arguments arrive as plain integers (device pointers,
// sizes, element strides, the current stream) from the wrappers in
// kernels/*/ops.py, which check devices, types, shapes and strides first.
// Every launch is followed by C10_CUDA_KERNEL_LAUNCH_CHECK(), which raises
// if the launch was refused (too many threads, too much shared memory).
#include <torch/extension.h>

#include <c10/cuda/CUDAException.h>

#include "kernels.h"

namespace {

using i64 = int64_t;

template <typename T>
T* ptr(i64 p) {
  return reinterpret_cast<T*>(static_cast<intptr_t>(p));
}

cudaStream_t as_stream(i64 s) {
  return reinterpret_cast<cudaStream_t>(static_cast<intptr_t>(s));
}

void matmul(i64 a, i64 b, i64 c, int in_type, int out_type, int batch, int m,
            int n, int k, i64 sa, i64 lda, i64 sb, i64 ldb, i64 sc, i64 ldc,
            i64 stream) {
  repro_matmul(ptr<const void>(a), ptr<const void>(b), ptr<void>(c), in_type,
               out_type, batch, m, n, k, sa, lda, sb, ldb, sc, ldc,
               as_stream(stream));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void trsm_diag(i64 u, i64 b, i64 x, int batch, int m, int nb, i64 su,
               i64 ldu, i64 sb, i64 ldb, i64 sx, i64 ldx, i64 stream) {
  repro_trsm_diag(ptr<const float>(u), ptr<const float>(b), ptr<float>(x),
                  batch, m, nb, su, ldu, sb, ldb, sx, ldx, as_stream(stream));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void cholesky_block(i64 a, i64 l, int batch, int nb, i64 sa, i64 lda, i64 sl,
                    i64 ldl, i64 stream) {
  repro_cholesky_block(ptr<const float>(a), ptr<float>(l), batch, nb, sa, lda,
                       sl, ldl, as_stream(stream));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("matmul", &matmul, "K1: batched C = A @ B (fp32 accumulation)");
  m.def("trsm_diag", &trsm_diag, "K2: batched X U = B, one diagonal block");
  m.def("cholesky_block", &cholesky_block,
        "K3: batched Cholesky factor of one SPD block");
}
