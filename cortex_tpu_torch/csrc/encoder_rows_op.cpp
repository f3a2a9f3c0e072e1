// PyTorch binding of the encoder's residual + LayerNorm (encoder_rows.cu,
// E1): registers torch.ops.cortex_tpu_torch.add_layer_norm, checks every
// argument, allocates the output and enqueues the kernel on the current
// stream of the tensors' device (no host synchronisation). A launch the
// runtime refuses raises; nothing here falls back to another
// implementation.

#include <cstdint>

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <c10/core/DeviceGuard.h>
#include <c10/core/impl/VirtualGuardImpl.h>
#include <torch/library.h>

extern "C" int cortex_add_layer_norm_launch(const void* x, const void* r,
                                            const void* g, const void* b,
                                            int64_t rows, int h,
                                            int64_t r_rows, float eps,
                                            void* y, void* stream);
extern "C" const char* cortex_cuda_error_string(int err);

namespace {

void check_arg(const at::Tensor& t, const char* name, int64_t dim,
               const at::Device& device) {
  const char* op = "add_layer_norm";
  TORCH_CHECK(t.device() == device, op, ": ", name, " is on ", t.device(),
              ", expected ", device);
  TORCH_CHECK(t.scalar_type() == at::kFloat, op, ": ", name,
              " must be float32, got ", t.scalar_type());
  TORCH_CHECK(t.dim() == dim, op, ": ", name, " must have ", dim,
              " dimensions, got ", t.sizes());
  TORCH_CHECK(t.is_contiguous(), op, ": ", name, " must be contiguous");
}

bool aligned(const at::Tensor& t) {
  return reinterpret_cast<std::uintptr_t>(t.data_ptr()) % 16 == 0;
}

at::Tensor add_layer_norm_cuda(const at::Tensor& x, const at::Tensor& r,
                               const at::Tensor& g, const at::Tensor& b,
                               double eps) {
  const at::Device device = x.device();
  TORCH_CHECK(device.is_cuda(), "add_layer_norm: tensors must be on CUDA");
  check_arg(x, "x", 2, device);
  check_arg(r, "r", 2, device);
  check_arg(g, "g", 1, device);
  check_arg(b, "b", 1, device);
  const int64_t rows = x.size(0), h = x.size(1), r_rows = r.size(0);
  TORCH_CHECK(h >= 4 && h <= 1024 && h % 4 == 0,
              "add_layer_norm: the kernel takes h <= 1024 with h % 4 == 0, "
              "got ", h);
  TORCH_CHECK(r.size(1) == h && r_rows >= 1 && rows % r_rows == 0,
              "add_layer_norm: r must be [P, ", h, "] with P dividing ",
              rows, ", got ", r.sizes());
  TORCH_CHECK(g.size(0) == h && b.size(0) == h,
              "add_layer_norm: g and b must be [", h, "]");

  const c10::DeviceGuard guard(device);
  auto y = at::empty({rows, h}, x.options());
  TORCH_CHECK(aligned(x) && aligned(r) && aligned(g) && aligned(b) &&
                  aligned(y),
              "add_layer_norm: every tensor must start on 16 bytes");
  const c10::impl::VirtualGuardImpl impl(device.type());
  const int err = cortex_add_layer_norm_launch(
      x.data_ptr(), r.data_ptr(), g.data_ptr(), b.data_ptr(), rows,
      static_cast<int>(h), r_rows, static_cast<float>(eps), y.data_ptr(),
      impl.getStream(device).native_handle());
  TORCH_CHECK(err == 0, "add_layer_norm: kernel launch failed: ",
              cortex_cuda_error_string(err));
  return y;
}

}  // namespace

TORCH_LIBRARY_FRAGMENT(cortex_tpu_torch, m) {
  m.def("add_layer_norm(Tensor x, Tensor r, Tensor g, Tensor b, float eps) "
        "-> Tensor");
}

TORCH_LIBRARY_IMPL(cortex_tpu_torch, CUDA, m) {
  m.impl("add_layer_norm", &add_layer_norm_cuda);
}
