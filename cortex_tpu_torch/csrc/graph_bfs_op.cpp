// PyTorch binding of the hop-depth kernels (graph_bfs.cu): registers
// torch.ops.cortex_tpu_torch.frontier_bfs and frontier_bfs_compact (G1)
// and bfs_relax (G2), checks every argument, allocates the outputs and the
// kernels' scratch (the compact walk's dist scratch is the caller's) and
// enqueues the kernels on the current stream of the tensors' device (no
// host synchronisation). A launch the runtime refuses raises; nothing
// here falls back to another implementation. Anchor values are checked
// by the Python wrapper (ops/graph_bfs.py), which sees them before the
// launch.

#include <algorithm>
#include <cstdint>
#include <tuple>

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <c10/core/DeviceGuard.h>
#include <c10/core/impl/VirtualGuardImpl.h>
#include <torch/library.h>

extern "C" int cortex_frontier_walk_launch(const void* nbrs, int n, int d,
                                           const void* anchors, int a_count,
                                           int hops, int cap, void* dist,
                                           void* frontier, void* counts,
                                           void* overflow, void* out,
                                           int out_cap, void* stream);
extern "C" int cortex_bfs_relax_launch(const void* nbrs, int n, int d,
                                       int vec4, const void* dist0,
                                       int a_count, int rounds, void* out,
                                       void* work, void* stream);
extern "C" const char* cortex_cuda_error_string(int err);

namespace {

constexpr int64_t kMaxHops = 8;   // the reference's static hop ceiling
constexpr int64_t kMaxInt32 = (int64_t{1} << 31) - 1;

void check_arg(const char* op, const at::Tensor& t, const char* name,
               int64_t dim, const at::Device& device) {
  TORCH_CHECK(t.device() == device, op, ": ", name, " is on ", t.device(),
              ", expected ", device);
  TORCH_CHECK(t.scalar_type() == at::kInt, op, ": ", name,
              " must be int32, got ", t.scalar_type());
  TORCH_CHECK(t.dim() == dim, op, ": ", name, " must have ", dim,
              " dims, got ", t.sizes());
  TORCH_CHECK(t.is_contiguous(), op, ": ", name, " must be contiguous");
}

void check_table(const char* op, const at::Tensor& nbrs) {
  const int64_t n = nbrs.size(0), d = nbrs.size(1);
  TORCH_CHECK(n >= 1 && d >= 1 && n * d <= kMaxInt32, op,
              ": nbrs must be [N, D] with N, D >= 1 and N * D < 2^31, got ",
              nbrs.sizes());
}

void* current_stream(const at::Device& device) {
  const c10::impl::VirtualGuardImpl impl(device.type());
  return impl.getStream(device).native_handle();
}

// The checks both forms of the walk share.
void check_walk(const char* op, const at::Tensor& nbrs,
                const at::Tensor& anchors, int64_t hops, int64_t cap) {
  const at::Device device = nbrs.device();
  TORCH_CHECK(device.is_cuda(), op, ": tensors must be on CUDA");
  check_arg(op, nbrs, "nbrs", 2, device);
  check_arg(op, anchors, "anchors", 1, device);
  check_table(op, nbrs);
  TORCH_CHECK(hops >= 0 && hops <= kMaxHops, op, ": hops=", hops,
              " out of range [0, ", kMaxHops, "]");
  TORCH_CHECK(cap >= 1 && cap * nbrs.size(1) <= kMaxInt32, op, ": cap=",
              cap, " out of range [1, 2^31 / D)");
  TORCH_CHECK(anchors.size(0) <= cap, op, ": ", anchors.size(0),
              " anchors exceed the frontier cap ", cap);
}

int launch_walk(const at::Tensor& nbrs, const at::Tensor& anchors,
                int64_t hops, int64_t cap, const at::Tensor& dist,
                void* overflow, void* out, int64_t out_cap) {
  auto frontier = at::empty({2 * cap}, nbrs.options());
  auto counts = at::empty({hops + 2}, nbrs.options());
  return cortex_frontier_walk_launch(
      nbrs.data_ptr(), static_cast<int>(nbrs.size(0)),
      static_cast<int>(nbrs.size(1)), anchors.data_ptr(),
      static_cast<int>(anchors.size(0)), static_cast<int>(hops),
      static_cast<int>(cap), dist.data_ptr(), frontier.data_ptr(),
      counts.data_ptr(), overflow, out, static_cast<int>(out_cap),
      current_stream(nbrs.device()));
}

std::tuple<at::Tensor, at::Tensor> frontier_bfs_cuda(
    const at::Tensor& nbrs, const at::Tensor& anchors, int64_t hops,
    int64_t cap) {
  const char* op = "frontier_bfs";
  check_walk(op, nbrs, anchors, hops, cap);
  const c10::DeviceGuard guard(nbrs.device());
  auto dist = at::empty({nbrs.size(0)}, nbrs.options());
  auto overflow = at::empty({1}, nbrs.options().dtype(at::kBool));
  const int err = launch_walk(nbrs, anchors, hops, cap, dist,
                              overflow.data_ptr(), nullptr, 0);
  TORCH_CHECK(err == 0, op, ": kernel launch failed: ",
              cortex_cuda_error_string(err));
  return {dist, overflow.squeeze()};
}

// Returns [2 + 2 * out_cap] int32: reached count, overflow, rows
// [out_cap], depths [out_cap]. scratch [N] int32 holds 2^30 everywhere
// and is left so.
at::Tensor frontier_bfs_compact_cuda(const at::Tensor& nbrs,
                                     const at::Tensor& anchors, int64_t hops,
                                     int64_t cap, int64_t out_cap,
                                     const at::Tensor& scratch) {
  const char* op = "frontier_bfs_compact";
  check_walk(op, nbrs, anchors, hops, cap);
  check_arg(op, scratch, "scratch", 1, nbrs.device());
  TORCH_CHECK(scratch.size(0) == nbrs.size(0), op, ": scratch must be [",
              nbrs.size(0), "], got ", scratch.sizes());
  TORCH_CHECK(out_cap >= 1 && 2 + 2 * out_cap <= kMaxInt32, op,
              ": out_cap=", out_cap, " out of range [1, 2^30)");
  const c10::DeviceGuard guard(nbrs.device());
  auto out = at::empty({2 + 2 * out_cap}, nbrs.options());
  const int err = launch_walk(nbrs, anchors, hops, cap, scratch, nullptr,
                              out.data_ptr(), out_cap);
  TORCH_CHECK(err == 0, op, ": kernel launch failed: ",
              cortex_cuda_error_string(err));
  return out;
}

at::Tensor bfs_relax_cuda(const at::Tensor& nbrs, const at::Tensor& dist0,
                          int64_t hops) {
  const char* op = "bfs_relax";
  const at::Device device = nbrs.device();
  TORCH_CHECK(device.is_cuda(), op, ": tensors must be on CUDA");
  check_arg(op, nbrs, "nbrs", 2, device);
  check_arg(op, dist0, "dist0", 2, device);
  check_table(op, nbrs);
  const int64_t n = nbrs.size(0), d = nbrs.size(1);
  const int64_t a = dist0.size(0);
  TORCH_CHECK(dist0.size(1) == n, op, ": dist0 must be [A, ", n,
              "], got ", dist0.sizes());
  TORCH_CHECK(a >= 1, op, ": dist0 must hold at least one anchor");
  // the reference's loop runs 8 rounds and masks those past `hops`
  const int64_t rounds = hops < 0 ? 0 : (hops > kMaxHops ? kMaxHops : hops);

  const c10::DeviceGuard guard(device);
  auto out = at::empty({a, n}, dist0.options());
  // A = 1: ping-pong buffers of [N]; A > 1: two anchor-minor buffers of
  // ceil(A / 8) tiles of [N, 8] (graph_bfs.cu)
  const int64_t nwork =
      a == 1 ? std::min<int64_t>(std::max<int64_t>(rounds - 1, 0), 2) * n
             : (rounds == 0 ? 0 : 2 * ((a + 7) / 8) * 8 * n);
  auto work = at::empty({nwork}, dist0.options());
  const bool vec4 =
      d % 4 == 0 &&
      reinterpret_cast<std::uintptr_t>(nbrs.data_ptr()) % 16 == 0;
  const int err = cortex_bfs_relax_launch(
      nbrs.data_ptr(), static_cast<int>(n), static_cast<int>(d), vec4 ? 1 : 0,
      dist0.data_ptr(), static_cast<int>(a), static_cast<int>(rounds),
      out.data_ptr(), nwork ? work.data_ptr() : nullptr,
      current_stream(device));
  TORCH_CHECK(err == 0, op, ": kernel launch failed: ",
              cortex_cuda_error_string(err));
  return out;
}

}  // namespace

TORCH_LIBRARY_FRAGMENT(cortex_tpu_torch, m) {
  m.def(
      "frontier_bfs(Tensor nbrs, Tensor anchors, int hops, int cap) -> "
      "(Tensor, Tensor)");
  m.def(
      "frontier_bfs_compact(Tensor nbrs, Tensor anchors, int hops, int cap, "
      "int out_cap, Tensor scratch) -> Tensor");
  m.def("bfs_relax(Tensor nbrs, Tensor dist0, int hops) -> Tensor");
}

TORCH_LIBRARY_IMPL(cortex_tpu_torch, CUDA, m) {
  m.impl("frontier_bfs", &frontier_bfs_cuda);
  m.impl("frontier_bfs_compact", &frontier_bfs_compact_cuda);
  m.impl("bfs_relax", &bfs_relax_cuda);
}
