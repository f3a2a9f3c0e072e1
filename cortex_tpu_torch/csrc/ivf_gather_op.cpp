// PyTorch binding of the IVF gather-score kernel (ivf_gather.cu):
// registers torch.ops.cortex_tpu_torch.probed_scores, checks every
// argument, allocates the outputs and the plan's scratch and enqueues
// the kernels on the current stream of the tensors' device (no host
// synchronisation). A launch the runtime refuses raises; nothing here
// falls back to another implementation.
//
// The file includes no CUDA header: the stream comes from PyTorch's
// device-generic guard interface, so the host compiler builds it alone.

#include <cstdint>
#include <tuple>

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <c10/core/DeviceGuard.h>
#include <c10/core/impl/VirtualGuardImpl.h>
#include <torch/library.h>

extern "C" int64_t cortex_probed_scores_scratch(int b, int p,
                                                int n_clusters, int d);
extern "C" int cortex_probed_scores_launch(
    const void* emb, const void* rinv, const void* slot_rows,
    const void* kind_sl, const void* agent_sl, const void* probe,
    const void* qi8, const void* ak, const void* aa, const void* ex,
    void* scores, void* rows, void* scratch, int b, int p, int n_clusters,
    int l_count, int d, int filtered, int aligned, void* stream);
extern "C" const char* cortex_cuda_error_string(int err);

namespace {

constexpr int64_t kMaxKinds = 16;
constexpr int64_t kMaxExclude = 64;
// A chunk's queries stay in shared memory: 64 of them up to d 2048, 32 at
// d 4096 (128 KiB). K1's limit too (flat_scan_op.cpp), and the port's
// config refuses wider rows at open (config.py::KERNEL_MAX_DIM).
constexpr int64_t kMaxDim = 4096;
constexpr int64_t kMaxInt32 = (int64_t{1} << 31) - 1;

void check_arg(const at::Tensor& t, const char* name, at::ScalarType dtype,
               int64_t dim, const at::Device& device) {
  TORCH_CHECK(t.device() == device, "probed_scores: ", name, " is on ",
              t.device(), ", expected ", device);
  TORCH_CHECK(t.scalar_type() == dtype, "probed_scores: ", name,
              " must be ", dtype, ", got ", t.scalar_type());
  TORCH_CHECK(t.dim() == dim, "probed_scores: ", name, " must have ", dim,
              " dims, got ", t.sizes());
  TORCH_CHECK(t.is_contiguous(), "probed_scores: ", name,
              " must be contiguous");
}

std::tuple<at::Tensor, at::Tensor> probed_scores_cuda(
    const at::Tensor& emb_i8, const at::Tensor& rinv_sl,
    const at::Tensor& slot_rows, const at::Tensor& kind_sl,
    const at::Tensor& agent_sl, const at::Tensor& probe,
    const at::Tensor& qi8, const at::Tensor& ak, const at::Tensor& aa,
    const at::Tensor& ex, bool filtered) {
  const at::Device device = emb_i8.device();
  TORCH_CHECK(device.is_cuda(), "probed_scores: tensors must be on CUDA");
  check_arg(emb_i8, "emb_i8", at::kChar, 3, device);
  check_arg(rinv_sl, "rinv_sl", at::kFloat, 2, device);
  check_arg(slot_rows, "slot_rows", at::kInt, 2, device);
  check_arg(kind_sl, "kind_sl", at::kInt, 2, device);
  check_arg(agent_sl, "agent_sl", at::kInt, 2, device);
  check_arg(probe, "probe", at::kInt, 2, device);
  check_arg(qi8, "qi8", at::kChar, 2, device);
  check_arg(ak, "ak", at::kInt, 1, device);
  check_arg(aa, "aa", at::kInt, 1, device);
  check_arg(ex, "ex", at::kInt, 1, device);

  const int64_t c = emb_i8.size(0);
  const int64_t l = emb_i8.size(1);
  const int64_t d = emb_i8.size(2);
  const int64_t b = probe.size(0);
  const int64_t p = probe.size(1);
  for (const at::Tensor* t : {&rinv_sl, &slot_rows, &kind_sl, &agent_sl}) {
    TORCH_CHECK(t->size(0) == c && t->size(1) == l,
                "probed_scores: metadata planes must be [C, L] = [", c,
                ", ", l, "], got ", t->sizes());
  }
  TORCH_CHECK(qi8.size(0) == b && qi8.size(1) == d,
              "probed_scores: qi8 must be [B, d] = [", b, ", ", d,
              "], got ", qi8.sizes());
  TORCH_CHECK(ak.size(0) == kMaxKinds, "probed_scores: ak must hold ",
              kMaxKinds, " codes");
  TORCH_CHECK(aa.size(0) == 1, "probed_scores: aa must hold 1 code");
  TORCH_CHECK(ex.size(0) == kMaxExclude, "probed_scores: ex must hold ",
              kMaxExclude, " rows");
  TORCH_CHECK(d >= 1 && d <= kMaxDim, "probed_scores: d=", d,
              " out of range [1, ", kMaxDim, "]");
  TORCH_CHECK(c * l <= kMaxInt32 && p * l <= kMaxInt32,
              "probed_scores: layout too large for int32 indexing");
  // the batch has no grid dimension of its own: only the (b, j) pairs,
  // sorted in int32, bound it
  TORCH_CHECK(b * p <= kMaxInt32, "probed_scores: B * p = ", b * p,
              " probes exceed int32 indexing");

  const c10::DeviceGuard guard(device);
  auto scores = at::empty({b, p * l}, emb_i8.options().dtype(at::kFloat));
  auto rows = at::empty({b, p * l}, emb_i8.options().dtype(at::kInt));
  auto scratch = at::empty(
      {cortex_probed_scores_scratch(static_cast<int>(b), static_cast<int>(p),
                                    static_cast<int>(c),
                                    static_cast<int>(d))},
      emb_i8.options().dtype(at::kInt));
  const bool aligned =
      d % 16 == 0 &&
      reinterpret_cast<std::uintptr_t>(emb_i8.data_ptr()) % 16 == 0 &&
      reinterpret_cast<std::uintptr_t>(qi8.data_ptr()) % 16 == 0;
  const c10::impl::VirtualGuardImpl impl(device.type());
  void* stream = impl.getStream(device).native_handle();
  const int err = cortex_probed_scores_launch(
      emb_i8.data_ptr(), rinv_sl.data_ptr(), slot_rows.data_ptr(),
      kind_sl.data_ptr(), agent_sl.data_ptr(), probe.data_ptr(),
      qi8.data_ptr(), ak.data_ptr(), aa.data_ptr(), ex.data_ptr(),
      scores.data_ptr(), rows.data_ptr(), scratch.data_ptr(),
      static_cast<int>(b), static_cast<int>(p), static_cast<int>(c),
      static_cast<int>(l), static_cast<int>(d), filtered ? 1 : 0,
      aligned ? 1 : 0, stream);
  TORCH_CHECK(err == 0, "probed_scores: kernel launch failed: ",
              cortex_cuda_error_string(err));
  return {scores, rows};
}

}  // namespace

TORCH_LIBRARY(cortex_tpu_torch, m) {
  m.def(
      "probed_scores(Tensor emb_i8, Tensor rinv_sl, Tensor slot_rows, "
      "Tensor kind_sl, Tensor agent_sl, Tensor probe, Tensor qi8, "
      "Tensor ak, Tensor aa, Tensor ex, bool filtered) -> (Tensor, Tensor)");
}

TORCH_LIBRARY_IMPL(cortex_tpu_torch, CUDA, m) {
  m.impl("probed_scores", &probed_scores_cuda);
}
