// PyTorch binding of the flat-index kernels (flat_scan.cu): registers
// torch.ops.cortex_tpu_torch.quant_scan (K1, the per-partition partials
// of the int8 candidate scan) and quant_rerank (K2), checks every
// argument, asks flat_scan.cu for K1's launch shape, allocates the
// outputs and enqueues the kernel on the current stream of the tensors'
// device. A launch the runtime refuses raises; nothing here falls back
// to another implementation.

#include <algorithm>
#include <cstdint>
#include <tuple>

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <ATen/ops/zeros.h>
#include <c10/core/DeviceGuard.h>
#include <c10/core/impl/VirtualGuardImpl.h>
#include <torch/library.h>

#include "flat_scan.cuh"

namespace {

constexpr int64_t kMaxScanDim = 4096;      // K1's queries in shared memory
constexpr int64_t kMaxScanBatch = 65535 * 16;   // K1's grid.y query groups
constexpr int64_t kMaxCand = 16384;        // K2 sorts cand in shared memory
constexpr int64_t kMaxRerankDim = 8192;
// K2 runs a cluster of up to 8 blocks per query in grid.x
constexpr int64_t kMaxRerankBatch = ((int64_t{1} << 31) - 1) / 8;

void check_arg(const char* op, const at::Tensor& t, const char* name,
               at::ScalarType dtype, int64_t dim, const at::Device& device) {
  TORCH_CHECK(t.device() == device, op, ": ", name, " is on ", t.device(),
              ", expected ", device);
  TORCH_CHECK(t.scalar_type() == dtype, op, ": ", name, " must be ", dtype,
              ", got ", t.scalar_type());
  TORCH_CHECK(t.dim() == dim, op, ": ", name, " must have ", dim,
              " dims, got ", t.sizes());
  TORCH_CHECK(t.is_contiguous(), op, ": ", name, " must be contiguous");
}

void* current_stream(const at::Device& device) {
  const c10::impl::VirtualGuardImpl impl(device.type());
  return impl.getStream(device).native_handle();
}

std::tuple<at::Tensor, at::Tensor> quant_scan_cuda(
    const at::Tensor& emb_i8, const at::Tensor& rinv, const at::Tensor& qi8,
    const at::Tensor& qs, const at::Tensor& bias, int64_t cand) {
  const char* op = "quant_scan";
  const at::Device device = emb_i8.device();
  TORCH_CHECK(device.is_cuda(), op, ": tensors must be on CUDA");
  check_arg(op, emb_i8, "emb_i8", at::kChar, 2, device);
  check_arg(op, rinv, "rinv", at::kFloat, 1, device);
  check_arg(op, qi8, "qi8", at::kChar, 2, device);
  check_arg(op, qs, "qs", at::kFloat, 1, device);
  check_arg(op, bias, "bias", at::kFloat, 1, device);
  const int64_t cap = emb_i8.size(0);
  const int64_t d = emb_i8.size(1);
  const int64_t b = qi8.size(0);
  TORCH_CHECK(rinv.size(0) == cap && bias.size(0) == cap, op,
              ": rinv and bias must hold cap = ", cap, " rows");
  TORCH_CHECK(qi8.size(1) == d, op, ": qi8 must be [B, ", d, "], got ",
              qi8.sizes());
  TORCH_CHECK(qs.size(0) == b, op, ": qs must hold B = ", b, " scales");
  TORCH_CHECK(cand >= 1, op, ": cand must be >= 1, got ", cand);
  TORCH_CHECK(cap >= 1 && cap < (int64_t{1} << 31), op, ": cap ", cap,
              " out of range [1, 2^31)");
  TORCH_CHECK(d >= 1 && d <= kMaxScanDim, op, ": d=", d,
              " out of range [1, ", kMaxScanDim, "]");
  TORCH_CHECK(b <= kMaxScanBatch, op, ": B=", b, " out of range [0, ",
              kMaxScanBatch, "]");

  const c10::DeviceGuard guard(device);
  const bool aligned =
      d % 16 == 0 &&
      reinterpret_cast<std::uintptr_t>(emb_i8.data_ptr()) % 16 == 0 &&
      reinterpret_cast<std::uintptr_t>(qi8.data_ptr()) % 16 == 0;
  const int kcand = static_cast<int>(std::min<int64_t>(cand, cap));
  QuantScanPlan plan{};
  int err = cortex_quant_scan_plan(static_cast<int>(b), static_cast<int>(cap),
                                   static_cast<int>(d), kcand,
                                   aligned ? 1 : 0, &plan);
  TORCH_CHECK(err == 0, op, ": no launch shape: ",
              cortex_cuda_error_string(err));
  const int64_t width = static_cast<int64_t>(plan.n_part) * plan.m;
  auto vals = at::empty({b, width}, emb_i8.options().dtype(at::kFloat));
  auto rows = at::empty({b, width}, emb_i8.options().dtype(at::kInt));
  const int64_t nbuf = plan.bufs_global
      ? static_cast<int64_t>(plan.n_groups) * plan.n_part * plan.qt *
            plan.capb
      : 0;
  auto buf_v = at::empty({nbuf}, emb_i8.options().dtype(at::kFloat));
  auto buf_i = at::empty({nbuf}, emb_i8.options().dtype(at::kInt));
  auto pub = at::zeros({static_cast<int64_t>(plan.n_groups) * plan.qt *
                        (plan.n_part + 1)},
                       emb_i8.options().dtype(at::kInt));
  err = cortex_quant_scan_launch(
      &plan, emb_i8.data_ptr(), rinv.data_ptr(), qi8.data_ptr(),
      qs.data_ptr(), bias.data_ptr(), vals.data_ptr(), rows.data_ptr(),
      buf_v.data_ptr(), buf_i.data_ptr(), pub.data_ptr(),
      static_cast<int>(b), static_cast<int>(cap), static_cast<int>(d), kcand,
      current_stream(device));
  TORCH_CHECK(err == 0, op, ": kernel launch failed: ",
              cortex_cuda_error_string(err));
  return {vals, rows};
}

std::tuple<at::Tensor, at::Tensor> quant_rerank_cuda(
    const at::Tensor& emb_f32, const at::Tensor& q, const at::Tensor& cv,
    const at::Tensor& ci, int64_t k) {
  const char* op = "quant_rerank";
  const at::Device device = emb_f32.device();
  TORCH_CHECK(device.is_cuda(), op, ": tensors must be on CUDA");
  check_arg(op, emb_f32, "emb_f32", at::kFloat, 2, device);
  check_arg(op, q, "q", at::kFloat, 2, device);
  check_arg(op, cv, "cv", at::kFloat, 2, device);
  check_arg(op, ci, "ci", at::kInt, 2, device);
  const int64_t cap = emb_f32.size(0);
  const int64_t d = emb_f32.size(1);
  const int64_t b = q.size(0);
  const int64_t cand = cv.size(1);
  TORCH_CHECK(q.size(1) == d, op, ": q must be [B, ", d, "], got ",
              q.sizes());
  TORCH_CHECK(cv.size(0) == b && ci.size(0) == b && ci.size(1) == cand, op,
              ": cv and ci must both be [B, cand] = [", b, ", ", cand,
              "], got ", cv.sizes(), " and ", ci.sizes());
  TORCH_CHECK(k >= 1, op, ": k must be >= 1, got ", k);
  TORCH_CHECK(cand >= 1 && cand <= kMaxCand, op, ": cand=", cand,
              " out of range [1, ", kMaxCand, "]");
  TORCH_CHECK(cap >= 1 && cap < (int64_t{1} << 31), op, ": cap ", cap,
              " out of range [1, 2^31)");
  TORCH_CHECK(d >= 1 && d <= kMaxRerankDim, op, ": d=", d,
              " out of range [1, ", kMaxRerankDim, "]");
  TORCH_CHECK(b <= kMaxRerankBatch, op, ": B=", b, " out of range [0, ",
              kMaxRerankBatch, "]");
  int64_t cand_p2 = 1;
  while (cand_p2 < cand) cand_p2 *= 2;

  const c10::DeviceGuard guard(device);
  auto vals = at::empty({b, k}, q.options());
  auto rows = at::empty({b, k}, q.options().dtype(at::kInt));
  const int err = cortex_quant_rerank_launch(
      emb_f32.data_ptr(), q.data_ptr(), cv.data_ptr(), ci.data_ptr(),
      vals.data_ptr(), rows.data_ptr(), static_cast<int>(b),
      static_cast<int>(cap), static_cast<int>(d), static_cast<int>(cand),
      static_cast<int>(cand_p2), static_cast<int>(k),
      current_stream(device));
  TORCH_CHECK(err == 0, op, ": kernel launch failed: ",
              cortex_cuda_error_string(err));
  return {vals, rows};
}

}  // namespace

TORCH_LIBRARY_FRAGMENT(cortex_tpu_torch, m) {
  m.def(
      "quant_scan(Tensor emb_i8, Tensor rinv, Tensor qi8, Tensor qs, "
      "Tensor bias, int cand) -> (Tensor, Tensor)");
  m.def(
      "quant_rerank(Tensor emb_f32, Tensor q, Tensor cv, Tensor ci, int k) "
      "-> (Tensor, Tensor)");
}

TORCH_LIBRARY_IMPL(cortex_tpu_torch, CUDA, m) {
  m.impl("quant_scan", &quant_scan_cuda);
  m.impl("quant_rerank", &quant_rerank_cuda);
}
