// PyTorch binding of the encoder's row kernels (encoder_rows.cu):
// registers torch.ops.cortex_tpu_torch.add_layer_norm (E1) and
// embed_layer_norm (its embedding form), checks every argument once
// (ops/encoder.py checks nothing on a CUDA call), allocates the output
// and enqueues the kernel on the current stream of the tensors' device
// (no host synchronisation). An argument the kernel does not take raises
// ValueError, with the messages ops/encoder.py's CPU checks give; a
// tensor that is not contiguous or does not start on 16 bytes is handed
// to the kernel as a contiguous copy (the encoder's own tensors never
// are); a launch the runtime refuses raises RuntimeError. Nothing here
// falls back to another implementation.

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
extern "C" int cortex_embed_layer_norm_launch(
    const void* ids, int ids64, const void* word, const void* pos,
    const void* type_row, const void* g, const void* b, int64_t rows,
    int64_t seq, int64_t vocab, int64_t pos_rows, int h, float eps, void* y,
    void* stream);
extern "C" const char* cortex_cuda_error_string(int err);

namespace {

constexpr int64_t kMaxWidth = 1024;     // a row: 8 float4s a lane

void check_float(const char* op, const at::Tensor& t, const char* name,
                 int64_t dim, const at::Device& device) {
  TORCH_CHECK_VALUE(t.device() == device, op, ": ", name, " is on ",
                    t.device(), ", the first argument on ", device);
  TORCH_CHECK_VALUE(t.scalar_type() == at::kFloat, op, ": ", name,
                    " must be float32, got ", t.scalar_type());
  TORCH_CHECK_VALUE(t.dim() == dim, op, ": ", name, " must have ", dim,
                    " dimensions, got ", t.sizes());
}

void check_width(const char* op, int64_t h) {
  TORCH_CHECK_VALUE(h >= 4 && h <= kMaxWidth && h % 4 == 0, op,
                    ": the kernel takes h <= ", kMaxWidth,
                    " with h % 4 == 0, got ", h);
}

void check_vector(const char* op, const at::Tensor& t, const char* name,
                  int64_t h, const at::Device& device) {
  check_float(op, t, name, 1, device);
  TORCH_CHECK_VALUE(t.size(0) == h, op, ": ", name, " must be [", h,
                    "], got ", t.sizes());
}

// t itself when it is contiguous and starts on 16 bytes (the kernels'
// float4 loads), else a contiguous copy, which does
at::Tensor dense_aligned(const at::Tensor& t) {
  if (t.is_contiguous() &&
      reinterpret_cast<std::uintptr_t>(t.data_ptr()) % 16 == 0) {
    return t;
  }
  return t.clone(at::MemoryFormat::Contiguous);
}

void check_launch(const char* op, int err) {
  TORCH_CHECK(err == 0, op, ": kernel launch failed: ",
              cortex_cuda_error_string(err));
}

at::Tensor add_layer_norm_cuda(const at::Tensor& x, const at::Tensor& r,
                               const at::Tensor& g, const at::Tensor& b,
                               double eps) {
  const char* op = "add_layer_norm";
  const at::Device device = x.device();
  TORCH_CHECK_VALUE(device.is_cuda(), op, ": x must be on CUDA, got ",
                    device);
  check_float(op, x, "x", 2, device);
  check_float(op, r, "r", 2, device);
  const int64_t rows = x.size(0), h = x.size(1), r_rows = r.size(0);
  TORCH_CHECK_VALUE(r.size(1) == h, op, ": x must be [T, h] and r [P, h], "
                    "got ", x.sizes(), " and ", r.sizes());
  TORCH_CHECK_VALUE(r_rows >= 1 && rows % r_rows == 0, op, ": r's ", r_rows,
                    " rows do not divide x's ", rows);
  check_vector(op, g, "g", h, device);
  check_vector(op, b, "b", h, device);
  check_width(op, h);

  const c10::DeviceGuard guard(device);
  const at::Tensor xd = dense_aligned(x), rd = dense_aligned(r),
                   gd = dense_aligned(g), bd = dense_aligned(b);
  auto y = at::empty({rows, h}, x.options());
  const c10::impl::VirtualGuardImpl impl(device.type());
  check_launch(op, cortex_add_layer_norm_launch(
      xd.data_ptr(), rd.data_ptr(), gd.data_ptr(), bd.data_ptr(), rows,
      static_cast<int>(h), r_rows, static_cast<float>(eps), y.data_ptr(),
      impl.getStream(device).native_handle()));
  return y;
}

at::Tensor embed_layer_norm_cuda(const at::Tensor& ids,
                                 const at::Tensor& word_emb,
                                 const at::Tensor& pos_emb,
                                 const at::Tensor& type_row,
                                 const at::Tensor& g, const at::Tensor& b,
                                 double eps) {
  const char* op = "embed_layer_norm";
  const at::Device device = ids.device();
  TORCH_CHECK_VALUE(device.is_cuda(), op, ": ids must be on CUDA, got ",
                    device);
  TORCH_CHECK_VALUE(ids.scalar_type() == at::kInt ||
                        ids.scalar_type() == at::kLong,
                    op, ": ids must be int32 or int64, got ",
                    ids.scalar_type());
  TORCH_CHECK_VALUE(ids.dim() == 2, op, ": ids must be [B, S], got ",
                    ids.sizes());
  check_float(op, word_emb, "word_emb", 2, device);
  check_float(op, pos_emb, "pos_emb", 2, device);
  const int64_t vocab = word_emb.size(0), h = word_emb.size(1),
                pos_rows = pos_emb.size(0);
  TORCH_CHECK_VALUE(pos_emb.size(1) == h && vocab >= 1 && pos_rows >= 1,
                    op, ": word_emb must be [V, h] and pos_emb [P, h] with "
                    "V, P >= 1, got ", word_emb.sizes(), " and ",
                    pos_emb.sizes());
  check_vector(op, type_row, "type_row", h, device);
  check_vector(op, g, "g", h, device);
  check_vector(op, b, "b", h, device);
  check_width(op, h);

  const c10::DeviceGuard guard(device);
  const int64_t seq = ids.size(1), rows = ids.size(0) * seq;
  const at::Tensor idd = ids.contiguous(), wd = dense_aligned(word_emb),
                   pd = dense_aligned(pos_emb), td = dense_aligned(type_row),
                   gd = dense_aligned(g), bd = dense_aligned(b);
  auto y = at::empty({rows, h}, word_emb.options());
  const c10::impl::VirtualGuardImpl impl(device.type());
  check_launch(op, cortex_embed_layer_norm_launch(
      idd.data_ptr(), ids.scalar_type() == at::kLong, wd.data_ptr(),
      pd.data_ptr(), td.data_ptr(), gd.data_ptr(), bd.data_ptr(), rows, seq,
      vocab, pos_rows, static_cast<int>(h), static_cast<float>(eps),
      y.data_ptr(), impl.getStream(device).native_handle()));
  return y;
}

}  // namespace

TORCH_LIBRARY_FRAGMENT(cortex_tpu_torch, m) {
  m.def("add_layer_norm(Tensor x, Tensor r, Tensor g, Tensor b, float eps) "
        "-> Tensor");
  m.def("embed_layer_norm(Tensor ids, Tensor word_emb, Tensor pos_emb, "
        "Tensor type_row, Tensor g, Tensor b, float eps) -> Tensor");
}

TORCH_LIBRARY_IMPL(cortex_tpu_torch, CUDA, m) {
  m.impl("add_layer_norm", &add_layer_norm_cuda);
  m.impl("embed_layer_norm", &embed_layer_norm_cuda);
}
