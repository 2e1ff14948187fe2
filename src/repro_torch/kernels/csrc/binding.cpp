// Python binding of the kernel launchers: the one source that includes
// PyTorch's headers.  Arguments arrive as plain integers (device pointers,
// sizes, element strides, the current stream) from the wrappers in
// kernels/*/ops.py, which check devices, types, shapes and strides first.
// Every launch is followed by C10_CUDA_KERNEL_LAUNCH_CHECK(), which raises
// if the launch was refused (too many threads, too much shared memory).
#include <torch/extension.h>

#include <c10/cuda/CUDAException.h>

#include <cstdio>
#include <vector>

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

// Raises, having launched nothing, for arguments the launcher refuses and
// when the fp32 body's shared-memory limit cannot be raised.
void matmul(i64 a, i64 b, i64 c, int in_type, int out_type, int batch, int m,
            int n, int k, i64 sa, i64 lda, i64 sb, i64 ldb, i64 sc, i64 ldc,
            i64 stream) {
  const cudaError_t err = repro_matmul(
      ptr<const void>(a), ptr<const void>(b), ptr<void>(c), in_type,
      out_type, batch, m, n, k, sa, lda, sb, ldb, sc, ldc, as_stream(stream));
  TORCH_CHECK(err != cudaErrorInvalidValue,
              "matmul: the launcher refused the arguments (type codes, "
              "m, n, batch >= 1, k >= 0, batch <= 65535)");
  TORCH_CHECK(err == cudaSuccess, cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// Registers, spill bytes, static and dynamic shared memory and resident
// CTAs an SM of K1's fp32 body on the current device.
std::vector<i64> matmul_info() {
  long long out[5] = {0, 0, 0, 0, 0};
  const cudaError_t err = repro_matmul_info(out);
  TORCH_CHECK(err == cudaSuccess, cudaGetErrorString(err));
  return std::vector<i64>(out, out + 5);
}

// Raises, having launched nothing, for an empty m or nb.
void trsm_diag(i64 u, i64 b, i64 x, int batch, int m, int nb, i64 su,
               i64 ldu, i64 sb, i64 ldb, i64 sx, i64 ldx, i64 stream) {
  const cudaError_t err = repro_trsm_diag(
      ptr<const float>(u), ptr<const float>(b), ptr<float>(x), batch, m, nb,
      su, ldu, sb, ldb, sx, ldx, as_stream(stream));
  TORCH_CHECK(err != cudaErrorInvalidValue,
              "trsm_diag: m and nb must be positive");
  TORCH_CHECK(err == cudaSuccess, cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// Raises, having launched nothing, for a block wider than one CTA holds
// (336 columns) and when the CTA's shared-memory limit cannot be raised.
void cholesky_block(i64 a, i64 l, int batch, int nb, i64 sa, i64 lda, i64 sl,
                    i64 ldl, i64 stream) {
  const cudaError_t err =
      repro_cholesky_block(ptr<const float>(a), ptr<float>(l), batch, nb, sa,
                           lda, sl, ldl, as_stream(stream));
  TORCH_CHECK(err != cudaErrorInvalidValue,
              "cholesky_block: one launch factors 1 to 336 columns");
  TORCH_CHECK(err == cudaSuccess, cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// Raises, having launched nothing, for a head dim other than 64, 96, 128,
// 256 or a multiple of 64 up to the widest whose tiles fit the device's
// shared memory of a block (the message states it), and for bf16 operands
// that the TMA loads cannot take (head dims up to 256).
void flash_attention(i64 q, i64 k, i64 v, i64 o, int dtype, int batch,
                     int heads, int kv_heads, int sq, int skv, int d,
                     std::vector<i64> strides, double scale, bool causal,
                     i64 stream) {
  TORCH_CHECK(strides.size() == 12, "flash_attention: 12 strides");
  const cudaError_t err = repro_flash_attention(
      ptr<const void>(q), ptr<const void>(k), ptr<const void>(v),
      ptr<void>(o), dtype, batch, heads, kv_heads, sq, skv, d,
      reinterpret_cast<const long long*>(strides.data()),
      static_cast<float>(scale), causal ? 1 : 0, as_stream(stream));
  if (err == cudaErrorInvalidValue) {
    // formatted here and passed as one C string: TORCH_CHECK's own
    // formatting of several arguments crashes in this extension
    char msg[256];
    std::snprintf(msg, sizeof msg,
                  "flash_attention: head dim must be 64, 96, 128, 256 or a "
                  "multiple of 64 up to %d, the widest whose tiles fit this "
                  "device's shared memory of a block; got %d",
                  repro_flash_attention_max_head_dim(), d);
    const char* what = msg;
    TORCH_CHECK(false, what);
  }
  TORCH_CHECK(err != cudaErrorMisalignedAddress,
              "flash_attention: bf16 q, k and v must be 16-byte aligned, "
              "with strides that are multiples of 8 elements");
  TORCH_CHECK(err == cudaSuccess, cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

i64 ssm_scan_workspace(int batch, int heads, int s, int dk, int dv) {
  return repro_ssm_scan_workspace(batch, heads, s, dk, dv);
}

// Raises, having launched nothing, for a dk above 256 or a size below 1,
// and for a workspace smaller than ssm_scan_workspace() asks.
void ssm_scan(i64 q, i64 k, i64 v, i64 log_a, i64 y, i64 work,
              i64 work_floats, int dtype, int batch, int heads, int s,
              int dk, int dv, std::vector<i64> strides, i64 stream) {
  TORCH_CHECK(strides.size() == 15, "ssm_scan: 15 strides");
  const cudaError_t err = repro_ssm_scan(
      ptr<const void>(q), ptr<const void>(k), ptr<const void>(v),
      ptr<const float>(log_a), ptr<void>(y), ptr<float>(work), work_floats,
      dtype, batch, heads, s, dk, dv,
      reinterpret_cast<const long long*>(strides.data()), as_stream(stream));
  TORCH_CHECK(err != cudaErrorInvalidValue,
              "ssm_scan: dk must be 1 to 256 and every size positive");
  TORCH_CHECK(err != cudaErrorInvalidDevicePointer,
              "ssm_scan: the workspace is smaller than ssm_scan_workspace "
              "asks");
  TORCH_CHECK(err == cudaSuccess, cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// Raises, having launched nothing, unless z, i, f, o and y are fp32,
// contiguous, (batch, s, w) alike and on one CUDA device, every size
// positive.
void slstm_scan(torch::Tensor z, torch::Tensor i, torch::Tensor f,
                torch::Tensor o, torch::Tensor y, i64 stream) {
  for (const torch::Tensor* t : {&z, &i, &f, &o, &y}) {
    TORCH_CHECK(t->scalar_type() == torch::kFloat32,
                "slstm_scan: z, i, f, o and y must be fp32");
    TORCH_CHECK(t->is_contiguous(),
                "slstm_scan: z, i, f, o and y must be contiguous");
    TORCH_CHECK(t->is_cuda() && t->device() == z.device(),
                "slstm_scan: z, i, f, o and y must share one CUDA device");
    TORCH_CHECK(t->dim() == 3 && t->sizes() == z.sizes(),
                "slstm_scan: z, i, f, o and y must be (batch, s, w) alike");
  }
  const cudaError_t err = repro_slstm_scan(
      z.data_ptr<float>(), i.data_ptr<float>(), f.data_ptr<float>(),
      o.data_ptr<float>(), y.data_ptr<float>(),
      static_cast<int>(z.size(0)), static_cast<int>(z.size(1)),
      static_cast<int>(z.size(2)), as_stream(stream));
  TORCH_CHECK(err != cudaErrorInvalidValue,
              "slstm_scan: every size must be positive");
  TORCH_CHECK(err == cudaSuccess, cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("matmul", &matmul, "K1: batched C = A @ B (fp32 accumulation)");
  m.def("matmul_info", &matmul_info,
        "K1's fp32 body: registers, spills, shared memory, CTAs an SM");
  m.def("trsm_diag", &trsm_diag, "K2: batched X U = B, one diagonal block");
  m.def("cholesky_block", &cholesky_block,
        "K3: batched Cholesky factor of one SPD block");
  m.def("flash_attention", &flash_attention,
        "K4: GQA forward attention with an online softmax");
  m.def("ssm_scan_workspace", &ssm_scan_workspace,
        "K5: fp32 workspace floats a call needs");
  m.def("ssm_scan", &ssm_scan, "K5: chunked decayed linear attention");
  m.def("slstm_scan", &slstm_scan, "K6: the sLSTM recurrence over time");
}
