// PyTorch binding of the kNN-graph block kernel (block_knn.cu, N1):
// registers torch.ops.cortex_tpu_torch.block_knn, checks every argument,
// allocates the [ch, L, r] output and enqueues the kernel on the current
// stream of the tensors' device (no host synchronisation), with the
// device scratch its running lists need when they do not fit shared
// memory. An argument the kernel does not take raises ValueError; a
// launch the runtime refuses raises RuntimeError; nothing here falls
// back to another implementation.

#include <cstdint>

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <c10/core/DeviceGuard.h>
#include <c10/core/impl/VirtualGuardImpl.h>
#include <torch/library.h>

extern "C" long long cortex_block_knn_scratch(int ch, int l_count, int d,
                                              int r, int aligned);
extern "C" int cortex_block_knn_launch(const void* emb, const void* rinv,
                                       const void* slot_rows,
                                       const void* mud, void* out,
                                       void* scratch, int ch, int l_count,
                                       int d, int r, int aligned,
                                       void* stream);
extern "C" const char* cortex_cuda_error_string(int err);

namespace {

constexpr int64_t kMaxInt32 = (int64_t{1} << 31) - 1;

void check_arg(const at::Tensor& t, const char* name, at::ScalarType dtype,
               int64_t dim, const at::Device& device) {
  TORCH_CHECK_VALUE(t.device() == device, "block_knn: ", name, " is on ",
                    t.device(), ", expected ", device);
  TORCH_CHECK_VALUE(t.scalar_type() == dtype, "block_knn: ", name,
                    " must be ", dtype, ", got ", t.scalar_type());
  TORCH_CHECK_VALUE(t.dim() == dim, "block_knn: ", name, " must have ", dim,
                    " dims, got ", t.sizes());
  TORCH_CHECK_VALUE(t.is_contiguous(), "block_knn: ", name,
                    " must be contiguous");
}

at::Tensor block_knn_cuda(const at::Tensor& emb_i8, const at::Tensor& rinv,
                          const at::Tensor& slot_rows, const at::Tensor& mud,
                          int64_t r) {
  const at::Device device = emb_i8.device();
  TORCH_CHECK_VALUE(device.is_cuda(), "block_knn: tensors must be on CUDA");
  check_arg(emb_i8, "emb_i8", at::kChar, 3, device);
  check_arg(rinv, "rinv", at::kFloat, 2, device);
  check_arg(slot_rows, "slot_rows", at::kInt, 2, device);
  check_arg(mud, "mud", at::kFloat, 2, device);
  const int64_t ch = emb_i8.size(0);
  const int64_t l = emb_i8.size(1);
  const int64_t d = emb_i8.size(2);
  for (const at::Tensor* t : {&rinv, &slot_rows, &mud}) {
    TORCH_CHECK_VALUE(t->size(0) == ch && t->size(1) == l,
                      "block_knn: per-slot planes must be [ch, L] = [", ch,
                      ", ", l, "], got ", t->sizes());
  }
  TORCH_CHECK_VALUE(r >= 1 && r < l, "block_knn: r=", r,
                    " out of range [1, L - 1 = ", l - 1, "]");
  TORCH_CHECK_VALUE(d >= 1, "block_knn: d must be positive");
  // the tensor maps and the work items index ch * L rows in 32 bits
  TORCH_CHECK_VALUE(ch * l <= kMaxInt32,
                    "block_knn: ch * L = ", ch * l, " exceeds int32");

  const c10::DeviceGuard guard(device);
  const bool aligned =
      d % 16 == 0 &&
      reinterpret_cast<std::uintptr_t>(emb_i8.data_ptr()) % 16 == 0;
  const long long scratch_bytes = cortex_block_knn_scratch(
      static_cast<int>(ch), static_cast<int>(l), static_cast<int>(d),
      static_cast<int>(r), aligned ? 1 : 0);
  TORCH_CHECK(scratch_bytes >= 0, "block_knn: device query failed: ",
              cortex_cuda_error_string(static_cast<int>(-scratch_bytes)));
  auto out = at::empty({ch, l, r}, emb_i8.options().dtype(at::kInt));
  at::Tensor scratch;
  if (scratch_bytes > 0) {
    scratch = at::empty({scratch_bytes}, emb_i8.options().dtype(at::kByte));
  }
  const c10::impl::VirtualGuardImpl impl(device.type());
  const int err = cortex_block_knn_launch(
      emb_i8.data_ptr(), rinv.data_ptr(), slot_rows.data_ptr(),
      mud.data_ptr(), out.data_ptr(),
      scratch_bytes > 0 ? scratch.data_ptr() : nullptr, static_cast<int>(ch),
      static_cast<int>(l), static_cast<int>(d), static_cast<int>(r),
      aligned ? 1 : 0, impl.getStream(device).native_handle());
  TORCH_CHECK(err == 0, "block_knn: kernel launch failed: ",
              cortex_cuda_error_string(err));
  return out;
}

}  // namespace

TORCH_LIBRARY_FRAGMENT(cortex_tpu_torch, m) {
  m.def(
      "block_knn(Tensor emb_i8, Tensor rinv, Tensor slot_rows, Tensor mud, "
      "int r) -> Tensor");
}

TORCH_LIBRARY_IMPL(cortex_tpu_torch, CUDA, m) {
  m.impl("block_knn", &block_knn_cuda);
}
