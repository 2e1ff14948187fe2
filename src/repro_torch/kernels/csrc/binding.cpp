// Python binding of the kernel launchers: the one source that includes
// PyTorch's headers.  Arguments arrive as plain integers (device pointers,
// sizes, element strides, the current stream) from the wrappers in
// kernels/*/ops.py, which check devices, types, shapes and strides first.
// Every launch is followed by C10_CUDA_KERNEL_LAUNCH_CHECK(), which raises
// if the launch was refused (too many threads, too much shared memory).
// It includes the tensor type and PyTorch's pybind11 casters, not
// <torch/extension.h>, the whole C++ frontend, which takes three times as
// long to compile.
#include <ATen/core/Tensor.h>
#include <c10/cuda/CUDAException.h>
#include <torch/csrc/utils/pybind.h>

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

// Returns the body that ran (kernels.h: 0 fp32, 1 bf16 on the tensor
// cores).  Raises, having launched nothing, for arguments the launcher
// refuses (a CTA tile that is not compiled among them), for bf16 operands
// TMA cannot load, and when a body's shared-memory limit cannot be raised.
int matmul(i64 a, i64 b, i64 c, int in_type, int out_type, int batch, int m,
           int n, int k, i64 sa, i64 lda, i64 sb, i64 ldb, i64 sc, i64 ldc,
           int tile_m, int tile_n, i64 stream) {
  int body = -1;
  const cudaError_t err = repro_matmul(
      ptr<const void>(a), ptr<const void>(b), ptr<void>(c), in_type,
      out_type, batch, m, n, k, sa, lda, sb, ldb, sc, ldc, tile_m, tile_n,
      &body, as_stream(stream));
  if (err == cudaErrorInvalidValue) {
    // formatted here and passed as one C string: TORCH_CHECK's own
    // formatting of several arguments crashes in this extension
    char msg[256];
    std::snprintf(msg, sizeof msg,
                  "matmul: the launcher refused the arguments (type codes, "
                  "m, n, batch >= 1, k >= 0 (bf16: k >= 1), batch <= 65535, "
                  "a compiled CTA tile; got %dx%d)",
                  tile_m, tile_n);
    const char* what = msg;
    TORCH_CHECK(false, what);
  }
  TORCH_CHECK(err != cudaErrorMisalignedAddress,
              "matmul: bf16 A and B must be 16-byte aligned, with row and "
              "batch strides that are multiples of 8 elements");
  TORCH_CHECK(err == cudaSuccess, cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return body;
}

// Registers, spill bytes, static and dynamic shared memory, resident CTAs
// an SM, threads a CTA and stages of K1's fp32 body at one CTA tile on the
// current device; raises for a tile that is not compiled.
std::vector<i64> matmul_info(int tile_m, int tile_n) {
  long long out[7] = {0, 0, 0, 0, 0, 0, 0};
  const cudaError_t err = repro_matmul_info(tile_m, tile_n, out);
  TORCH_CHECK(err != cudaErrorInvalidValue,
              "matmul_info: no configuration of that CTA tile is compiled");
  TORCH_CHECK(err == cudaSuccess, cudaGetErrorString(err));
  return std::vector<i64>(out, out + 7);
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

// Returns the body that ran (kernels.h: REPRO_K4_*).  Raises, having
// launched nothing, for a head dim other than 64, 96, 128, 256 or a
// multiple of 64 up to the widest the wide bodies take on this device (the
// message states it), and for operands the loads cannot take.
int flash_attention(i64 q, i64 k, i64 v, i64 o, int dtype, int batch,
                    int heads, int kv_heads, int sq, int skv, int d,
                    std::vector<i64> strides, double scale, bool causal,
                    i64 stream) {
  TORCH_CHECK(strides.size() == 12, "flash_attention: 12 strides");
  int body = -1;
  const cudaError_t err = repro_flash_attention(
      ptr<const void>(q), ptr<const void>(k), ptr<const void>(v),
      ptr<void>(o), dtype, batch, heads, kv_heads, sq, skv, d,
      reinterpret_cast<const long long*>(strides.data()),
      static_cast<float>(scale), causal ? 1 : 0, &body, as_stream(stream));
  if (err == cudaErrorInvalidValue) {
    // formatted here and passed as one C string: TORCH_CHECK's own
    // formatting of several arguments crashes in this extension
    char msg[256];
    std::snprintf(msg, sizeof msg,
                  "flash_attention: head dim must be 64, 96, 128, 256 or a "
                  "multiple of 64 up to %d, the widest the wide bodies take "
                  "on this device; got %d",
                  repro_flash_attention_max_head_dim(), d);
    const char* what = msg;
    TORCH_CHECK(false, what);
  }
  TORCH_CHECK(err != cudaErrorMisalignedAddress,
              "flash_attention: q, k and v (fp32: and o) must be 16-byte "
              "aligned, with strides that are multiples of 16 bytes");
  TORCH_CHECK(err == cudaSuccess, cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return body;
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

// Raises, having launched nothing, with the message of the first rule t
// breaks: fp32, contiguous, on like's CUDA device, of like's (batch, s, w)
// shape.  The messages are plain strings (ROADMAP.md, "How a slice
// lands").
void check_like(const at::Tensor& t, const at::Tensor& like,
                const char* fp32, const char* contiguous, const char* device,
                const char* shape) {
  TORCH_CHECK(t.scalar_type() == at::kFloat, fp32);
  TORCH_CHECK(t.is_contiguous(), contiguous);
  TORCH_CHECK(t.is_cuda() && t.device() == like.device(), device);
  TORCH_CHECK(t.dim() == 3 && t.sizes() == like.sizes(), shape);
}

i64 slstm_scan_workspace(i64 batch, i64 s, i64 w, i64 chunk) {
  return repro_slstm_scan_workspace(static_cast<int>(batch),
                                    static_cast<int>(s), static_cast<int>(w),
                                    static_cast<int>(chunk));
}

// Raises, having launched nothing, unless z, i, f, o and y are fp32,
// contiguous, (batch, s, w) alike and on one CUDA device, c, n and m are
// all empty or all like y, the workspace is fp32 on that device and holds
// what slstm_scan_workspace asks, every size is positive and the chunks
// number at most 65535.
void slstm_scan(at::Tensor z, at::Tensor i, at::Tensor f,
                at::Tensor o, at::Tensor y, at::Tensor c,
                at::Tensor n, at::Tensor m, at::Tensor work,
                i64 chunk, i64 stream) {
  for (const at::Tensor* t : {&z, &i, &f, &o, &y})
    check_like(*t, z, "slstm_scan: z, i, f, o and y must be fp32",
               "slstm_scan: z, i, f, o and y must be contiguous",
               "slstm_scan: z, i, f, o and y must share one CUDA device",
               "slstm_scan: z, i, f, o and y must be (batch, s, w) alike");
  const bool states = c.numel() > 0;
  TORCH_CHECK(states == (n.numel() > 0) && states == (m.numel() > 0),
              "slstm_scan: c, n and m must all be given or all be empty");
  if (states)
    for (const at::Tensor* t : {&c, &n, &m})
      check_like(*t, z, "slstm_scan: c, n and m must be fp32",
                 "slstm_scan: c, n and m must be contiguous",
                 "slstm_scan: c, n and m must share z's CUDA device",
                 "slstm_scan: c, n and m must be (batch, s, w) like z");
  TORCH_CHECK(work.scalar_type() == at::kFloat && work.is_cuda() &&
                  work.device() == z.device() && work.is_contiguous(),
              "slstm_scan: the workspace must be fp32 and contiguous on "
              "z's CUDA device");
  const cudaError_t err = repro_slstm_scan(
      z.data_ptr<float>(), i.data_ptr<float>(), f.data_ptr<float>(),
      o.data_ptr<float>(), y.data_ptr<float>(),
      states ? c.data_ptr<float>() : nullptr,
      states ? n.data_ptr<float>() : nullptr,
      states ? m.data_ptr<float>() : nullptr, work.data_ptr<float>(),
      work.numel(), static_cast<int>(z.size(0)), static_cast<int>(z.size(1)),
      static_cast<int>(z.size(2)), static_cast<int>(chunk),
      as_stream(stream));
  TORCH_CHECK(err != cudaErrorInvalidValue,
              "slstm_scan: every size must be positive and s / chunk at "
              "most 65535");
  TORCH_CHECK(err != cudaErrorInvalidDevicePointer,
              "slstm_scan: the workspace is smaller than "
              "slstm_scan_workspace asks");
  TORCH_CHECK(err == cudaSuccess, cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

i64 slstm_scan_bwd_workspace(i64 batch, i64 s, i64 w, i64 chunk) {
  return repro_slstm_scan_bwd_workspace(
      static_cast<int>(batch), static_cast<int>(s), static_cast<int>(w),
      static_cast<int>(chunk));
}

// Raises, having launched nothing, unless the twelve tensors are fp32,
// contiguous, (batch, s, w) alike and on one CUDA device, the workspace is
// fp32 on that device and holds what slstm_scan_bwd_workspace asks, every
// size is positive and the chunks number at most 65535.
void slstm_scan_bwd(at::Tensor z, at::Tensor i, at::Tensor f,
                    at::Tensor o, at::Tensor c, at::Tensor n,
                    at::Tensor m, at::Tensor dy, at::Tensor dz,
                    at::Tensor di, at::Tensor df, at::Tensor d_o,
                    at::Tensor work, i64 chunk, i64 stream) {
  for (const at::Tensor* t :
       {&z, &i, &f, &o, &c, &n, &m, &dy, &dz, &di, &df, &d_o})
    check_like(*t, z, "slstm_scan_bwd: every tensor must be fp32",
               "slstm_scan_bwd: every tensor must be contiguous",
               "slstm_scan_bwd: every tensor must share one CUDA device",
               "slstm_scan_bwd: every tensor must be (batch, s, w) alike");
  TORCH_CHECK(work.scalar_type() == at::kFloat && work.is_cuda() &&
                  work.device() == z.device() && work.is_contiguous(),
              "slstm_scan_bwd: the workspace must be fp32 and contiguous "
              "on z's CUDA device");
  const cudaError_t err = repro_slstm_scan_bwd(
      z.data_ptr<float>(), i.data_ptr<float>(), f.data_ptr<float>(),
      o.data_ptr<float>(), c.data_ptr<float>(), n.data_ptr<float>(),
      m.data_ptr<float>(), dy.data_ptr<float>(), dz.data_ptr<float>(),
      di.data_ptr<float>(), df.data_ptr<float>(), d_o.data_ptr<float>(),
      work.data_ptr<float>(), work.numel(), static_cast<int>(z.size(0)),
      static_cast<int>(z.size(1)), static_cast<int>(z.size(2)),
      static_cast<int>(chunk), as_stream(stream));
  TORCH_CHECK(err != cudaErrorInvalidValue,
              "slstm_scan_bwd: every size must be positive and s / chunk "
              "at most 65535");
  TORCH_CHECK(err != cudaErrorInvalidDevicePointer,
              "slstm_scan_bwd: the workspace is smaller than "
              "slstm_scan_bwd_workspace asks");
  TORCH_CHECK(err == cudaSuccess, cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("matmul", &matmul,
        "K1: batched C = A @ B (fp32 accumulation); returns the body run");
  m.def("matmul_info", &matmul_info,
        "K1's fp32 body at one CTA tile: registers, spills, shared memory, "
        "CTAs an SM, threads, stages");
  m.def("trsm_diag", &trsm_diag, "K2: batched X U = B, one diagonal block");
  m.def("cholesky_block", &cholesky_block,
        "K3: batched Cholesky factor of one SPD block");
  m.def("flash_attention", &flash_attention,
        "K4: GQA forward attention with an online softmax; returns the "
        "body run");
  m.def("ssm_scan_workspace", &ssm_scan_workspace,
        "K5: fp32 workspace floats a call needs");
  m.def("ssm_scan", &ssm_scan, "K5: chunked decayed linear attention");
  m.def("slstm_scan_workspace", &slstm_scan_workspace,
        "K6: fp32 workspace floats a call needs");
  m.def("slstm_scan", &slstm_scan,
        "K6: the sLSTM recurrence over time, a scan over chunks");
  m.def("slstm_scan_bwd_workspace", &slstm_scan_bwd_workspace,
        "K6's backward: fp32 workspace floats a call needs");
  m.def("slstm_scan_bwd", &slstm_scan_bwd,
        "K6's backward: a reverse scan over chunks");
}
