// PyTorch binding of retention eligibility (retention_eligibility.cu, R1):
// registers torch.ops.cortex_tpu_torch.retention_eligibility, checks every
// argument, allocates the bool [N] mask and enqueues the kernel on the
// current stream of the tensors' device (no host synchronisation). Each
// parameter is a 0-d tensor (one value for every node) or an [N] one (one
// a node). A launch the runtime refuses raises; nothing here falls back to
// another implementation.

#include <cstdint>

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <c10/core/DeviceGuard.h>
#include <c10/core/impl/VirtualGuardImpl.h>
#include <torch/library.h>

extern "C" int cortex_retention_eligibility_launch(
    const void* created, const void* last, const void* score,
    const void* inbound, int64_t n, int vec4, const void* now, int now_s,
    const void* ttl, int ttl_s, const void* grace, int grace_s,
    const void* min_score, int min_s, const void* protect, int protect_s,
    void* out, void* stream);
extern "C" const char* cortex_cuda_error_string(int err);

namespace {

constexpr const char* kOp = "retention_eligibility";

void check_type(const at::Tensor& t, const char* name, at::ScalarType type,
                const at::Device& device) {
  TORCH_CHECK(t.device() == device, kOp, ": ", name, " is on ", t.device(),
              ", expected ", device);
  TORCH_CHECK(t.scalar_type() == type, kOp, ": ", name, " must be ", type,
              ", got ", t.scalar_type());
}

void check_nodes(const at::Tensor& t, const char* name, at::ScalarType type,
                 int64_t n, const at::Device& device) {
  check_type(t, name, type, device);
  TORCH_CHECK(t.dim() == 1 && t.size(0) == n, kOp, ": ", name, " must be [",
              n, "], got ", t.sizes());
  TORCH_CHECK(t.is_contiguous(), kOp, ": ", name, " must be contiguous");
}

// the parameter's stride over the nodes: 0 for a 0-d tensor, 1 for [N]
int check_param(const at::Tensor& t, const char* name, at::ScalarType type,
                int64_t n, const at::Device& device) {
  check_type(t, name, type, device);
  if (t.dim() == 0) return 0;
  check_nodes(t, name, type, n, device);
  return 1;
}

bool aligned(const at::Tensor& t, std::uintptr_t bytes) {
  return reinterpret_cast<std::uintptr_t>(t.data_ptr()) % bytes == 0;
}

at::Tensor retention_eligibility_cuda(
    const at::Tensor& created_at, const at::Tensor& last_accessed_at,
    const at::Tensor& score, const at::Tensor& has_inbound,
    const at::Tensor& now, const at::Tensor& ttl_days,
    const at::Tensor& grace_days, const at::Tensor& min_score,
    const at::Tensor& protect_inbound) {
  const at::Device device = created_at.device();
  TORCH_CHECK(device.is_cuda(), kOp, ": tensors must be on CUDA");
  const int64_t n = created_at.dim() == 1 ? created_at.size(0) : -1;
  check_nodes(created_at, "created_at", at::kFloat, n, device);
  check_nodes(last_accessed_at, "last_accessed_at", at::kFloat, n, device);
  check_nodes(score, "score", at::kFloat, n, device);
  check_nodes(has_inbound, "has_inbound", at::kBool, n, device);
  const int now_s = check_param(now, "now", at::kFloat, n, device);
  const int ttl_s = check_param(ttl_days, "ttl_days", at::kFloat, n, device);
  const int grace_s =
      check_param(grace_days, "grace_days", at::kFloat, n, device);
  const int min_s = check_param(min_score, "min_score", at::kFloat, n, device);
  const int protect_s =
      check_param(protect_inbound, "protect_inbound", at::kBool, n, device);

  const c10::DeviceGuard guard(device);
  auto out = at::empty({n}, created_at.options().dtype(at::kBool));
  bool vec4 = aligned(created_at, 16) && aligned(last_accessed_at, 16) &&
              aligned(score, 16) && aligned(has_inbound, 4) &&
              aligned(out, 4);
  for (const auto* p : {&now, &ttl_days, &grace_days, &min_score}) {
    if (p->dim() == 1) vec4 = vec4 && aligned(*p, 16);
  }
  if (protect_inbound.dim() == 1) vec4 = vec4 && aligned(protect_inbound, 4);
  const c10::impl::VirtualGuardImpl impl(device.type());
  const int err = cortex_retention_eligibility_launch(
      created_at.data_ptr(), last_accessed_at.data_ptr(), score.data_ptr(),
      has_inbound.data_ptr(), n, vec4 ? 1 : 0, now.data_ptr(), now_s,
      ttl_days.data_ptr(), ttl_s, grace_days.data_ptr(), grace_s,
      min_score.data_ptr(), min_s, protect_inbound.data_ptr(), protect_s,
      out.data_ptr(), impl.getStream(device).native_handle());
  TORCH_CHECK(err == 0, kOp, ": kernel launch failed: ",
              cortex_cuda_error_string(err));
  return out;
}

}  // namespace

TORCH_LIBRARY_FRAGMENT(cortex_tpu_torch, m) {
  m.def(
      "retention_eligibility(Tensor created_at, Tensor last_accessed_at, "
      "Tensor score, Tensor has_inbound, Tensor now, Tensor ttl_days, "
      "Tensor grace_days, Tensor min_score, Tensor protect_inbound) -> "
      "Tensor");
}

TORCH_LIBRARY_IMPL(cortex_tpu_torch, CUDA, m) {
  m.impl("retention_eligibility", &retention_eligibility_cuda);
}
