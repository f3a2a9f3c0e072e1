// PyTorch binding of the decay sweep (decay_sweep.cu, D1): registers
// torch.ops.cortex_tpu_torch.decay_sweep, checks every argument,
// allocates the outputs (new_w f32 and three bool masks, one byte each)
// and enqueues the kernel on the current stream of the tensors' device
// (no host synchronisation). A launch the runtime refuses raises; nothing
// here falls back to another implementation.

#include <cstdint>
#include <tuple>

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <c10/core/DeviceGuard.h>
#include <c10/core/impl/VirtualGuardImpl.h>
#include <torch/library.h>

extern "C" int cortex_decay_sweep_launch(
    const void* w, const void* days, const void* imp, const void* exempt,
    int64_t n, int vec4, float rate, float shield, float del_thr,
    float prune_thr, void* new_w, void* del, void* prune, void* changed,
    void* stream);
extern "C" const char* cortex_cuda_error_string(int err);

namespace {

void check_arg(const at::Tensor& t, const char* name, at::ScalarType type,
               int64_t n, const at::Device& device) {
  const char* op = "decay_sweep";
  TORCH_CHECK(t.device() == device, op, ": ", name, " is on ", t.device(),
              ", expected ", device);
  TORCH_CHECK(t.scalar_type() == type, op, ": ", name, " must be ", type,
              ", got ", t.scalar_type());
  TORCH_CHECK(t.dim() == 1 && t.size(0) == n, op, ": ", name,
              " must be [", n, "], got ", t.sizes());
  TORCH_CHECK(t.is_contiguous(), op, ": ", name, " must be contiguous");
}

bool aligned(const at::Tensor& t, std::uintptr_t bytes) {
  return reinterpret_cast<std::uintptr_t>(t.data_ptr()) % bytes == 0;
}

std::tuple<at::Tensor, at::Tensor, at::Tensor, at::Tensor> decay_sweep_cuda(
    const at::Tensor& weights, const at::Tensor& days,
    const at::Tensor& max_importance, const at::Tensor& exempt,
    double daily_rate, double shield, double delete_threshold,
    double prune_threshold) {
  const at::Device device = weights.device();
  TORCH_CHECK(device.is_cuda(), "decay_sweep: tensors must be on CUDA");
  const int64_t n = weights.dim() == 1 ? weights.size(0) : -1;
  check_arg(weights, "weights", at::kFloat, n, device);
  check_arg(days, "days", at::kFloat, n, device);
  check_arg(max_importance, "max_importance", at::kFloat, n, device);
  check_arg(exempt, "exempt", at::kBool, n, device);

  const c10::DeviceGuard guard(device);
  auto new_w = at::empty({n}, weights.options());
  auto flags = weights.options().dtype(at::kBool);
  auto del = at::empty({n}, flags);
  auto prune = at::empty({n}, flags);
  auto changed = at::empty({n}, flags);
  const bool vec4 = aligned(weights, 16) && aligned(days, 16) &&
                    aligned(max_importance, 16) && aligned(exempt, 4) &&
                    aligned(new_w, 16) && aligned(del, 4) &&
                    aligned(prune, 4) && aligned(changed, 4);
  const c10::impl::VirtualGuardImpl impl(device.type());
  const int err = cortex_decay_sweep_launch(
      weights.data_ptr(), days.data_ptr(), max_importance.data_ptr(),
      exempt.data_ptr(), n, vec4 ? 1 : 0, static_cast<float>(daily_rate),
      static_cast<float>(shield), static_cast<float>(delete_threshold),
      static_cast<float>(prune_threshold), new_w.data_ptr(), del.data_ptr(),
      prune.data_ptr(), changed.data_ptr(),
      impl.getStream(device).native_handle());
  TORCH_CHECK(err == 0, "decay_sweep: kernel launch failed: ",
              cortex_cuda_error_string(err));
  return {new_w, del, prune, changed};
}

}  // namespace

TORCH_LIBRARY_FRAGMENT(cortex_tpu_torch, m) {
  m.def(
      "decay_sweep(Tensor weights, Tensor days, Tensor max_importance, "
      "Tensor exempt, float daily_rate, float shield, float delete_threshold, "
      "float prune_threshold) -> (Tensor, Tensor, Tensor, Tensor)");
}

TORCH_LIBRARY_IMPL(cortex_tpu_torch, CUDA, m) {
  m.impl("decay_sweep", &decay_sweep_cuda);
}
