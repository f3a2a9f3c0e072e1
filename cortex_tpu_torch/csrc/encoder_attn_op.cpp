// PyTorch binding of the encoder's masked attention (encoder_attn.cu, E2):
// registers torch.ops.cortex_tpu_torch.masked_attention, checks every
// argument, allocates the [B, S, H, dh] output, returns it as a
// [B, H, S, dh] view and enqueues the kernel on the current stream of the
// tensors' device (no host synchronisation). A launch the runtime refuses
// raises; nothing here falls back to another implementation.

#include <cmath>
#include <cstdint>

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <c10/core/DeviceGuard.h>
#include <c10/core/impl/VirtualGuardImpl.h>
#include <torch/library.h>

extern "C" int cortex_masked_attention_launch(
    const void* q, const void* k, const void* v, const void* mask_bias,
    int batch, int heads, int seq, int dh, const int64_t* q_strides,
    const int64_t* k_strides, const int64_t* v_strides, float scale,
    void* out, void* stream);
extern "C" const char* cortex_cuda_error_string(int err);

namespace {

void check_qkv(const at::Tensor& t, const char* name, at::IntArrayRef shape,
               const at::Device& device) {
  const char* op = "masked_attention";
  TORCH_CHECK(t.device() == device, op, ": ", name, " is on ", t.device(),
              ", expected ", device);
  TORCH_CHECK(t.scalar_type() == at::kFloat, op, ": ", name,
              " must be float32, got ", t.scalar_type());
  TORCH_CHECK(t.sizes() == shape, op, ": ", name, " must be ", shape,
              ", got ", t.sizes());
  TORCH_CHECK(t.stride(3) == 1 && t.stride(0) % 4 == 0 &&
                  t.stride(1) % 4 == 0 && t.stride(2) % 4 == 0 &&
                  reinterpret_cast<std::uintptr_t>(t.data_ptr()) % 16 == 0,
              op, ": ", name, "'s rows must be dense and 16-byte aligned, "
              "got strides ", t.strides());
}

at::Tensor masked_attention_cuda(const at::Tensor& q, const at::Tensor& k,
                                 const at::Tensor& v,
                                 const at::Tensor& mask_bias) {
  const at::Device device = q.device();
  TORCH_CHECK(device.is_cuda(), "masked_attention: tensors must be on CUDA");
  TORCH_CHECK(q.dim() == 4, "masked_attention: q must be [B, H, S, dh]");
  const int64_t batch = q.size(0), heads = q.size(1), seq = q.size(2),
                dh = q.size(3);
  TORCH_CHECK((dh == 32 || dh == 64) && seq >= 1 && seq <= 512,
              "masked_attention: the kernel takes dh 32 or 64 and "
              "1 <= S <= 512, got dh ", dh, ", S ", seq);
  TORCH_CHECK(batch * heads <= 0x7fffffff,
              "masked_attention: B * H must be < 2^31");
  check_qkv(q, "q", q.sizes(), device);
  check_qkv(k, "k", q.sizes(), device);
  check_qkv(v, "v", q.sizes(), device);
  TORCH_CHECK(mask_bias.device() == device &&
                  mask_bias.scalar_type() == at::kFloat &&
                  mask_bias.dim() == 2 && mask_bias.size(0) == batch &&
                  mask_bias.size(1) == seq && mask_bias.is_contiguous(),
              "masked_attention: mask_bias must be a contiguous float32 [",
              batch, ", ", seq, "] on ", device);

  const c10::DeviceGuard guard(device);
  auto out = at::empty({batch, seq, heads, dh}, q.options());
  const int64_t qs[3] = {q.stride(0), q.stride(1), q.stride(2)};
  const int64_t ks[3] = {k.stride(0), k.stride(1), k.stride(2)};
  const int64_t vs[3] = {v.stride(0), v.stride(1), v.stride(2)};
  const c10::impl::VirtualGuardImpl impl(device.type());
  const float scale =
      1.0f / std::sqrt(static_cast<float>(dh));  // the reference's / sqrt(dh)
  const int err = cortex_masked_attention_launch(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_bias.data_ptr(),
      static_cast<int>(batch), static_cast<int>(heads),
      static_cast<int>(seq), static_cast<int>(dh), qs, ks, vs, scale,
      out.data_ptr(), impl.getStream(device).native_handle());
  TORCH_CHECK(err == 0, "masked_attention: kernel launch failed: ",
              cortex_cuda_error_string(err));
  return out.permute({0, 2, 1, 3});
}

}  // namespace

TORCH_LIBRARY_FRAGMENT(cortex_tpu_torch, m) {
  m.def("masked_attention(Tensor q, Tensor k, Tensor v, Tensor mask_bias) "
        "-> Tensor");
}

TORCH_LIBRARY_IMPL(cortex_tpu_torch, CUDA, m) {
  m.impl("masked_attention", &masked_attention_cuda);
}
