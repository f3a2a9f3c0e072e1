// PyTorch binding of the hop-depth kernels (graph_bfs.cu): registers
// torch.ops.cortex_tpu_torch.frontier_bfs (G1) and bfs_relax (G2), checks
// every argument, allocates the outputs and the scratch and enqueues the
// kernels on the current stream of the tensors' device (no host
// synchronisation). A launch the runtime refuses raises; nothing here
// falls back to another implementation. Anchor values are checked by the
// Python wrapper (ops/graph_bfs.py), which sees them before the launch.

#include <cstdint>
#include <tuple>

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <c10/core/DeviceGuard.h>
#include <c10/core/impl/VirtualGuardImpl.h>
#include <torch/library.h>

extern "C" int cortex_frontier_bfs_launch(const void* nbrs, int n, int d,
                                          const void* anchors, int a_count,
                                          int hops, int cap, void* dist,
                                          void* frontier, void* counts,
                                          void* overflow, void* stream);
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

std::tuple<at::Tensor, at::Tensor> frontier_bfs_cuda(
    const at::Tensor& nbrs, const at::Tensor& anchors, int64_t hops,
    int64_t cap) {
  const char* op = "frontier_bfs";
  const at::Device device = nbrs.device();
  TORCH_CHECK(device.is_cuda(), op, ": tensors must be on CUDA");
  check_arg(op, nbrs, "nbrs", 2, device);
  check_arg(op, anchors, "anchors", 1, device);
  check_table(op, nbrs);
  const int64_t n = nbrs.size(0), d = nbrs.size(1);
  const int64_t a = anchors.size(0);
  TORCH_CHECK(hops >= 0 && hops <= kMaxHops, op, ": hops=", hops,
              " out of range [0, ", kMaxHops, "]");
  TORCH_CHECK(cap >= 1 && cap * d <= kMaxInt32, op, ": cap=", cap,
              " out of range [1, 2^31 / D)");
  TORCH_CHECK(a <= cap, op, ": ", a, " anchors exceed the frontier cap ",
              cap);

  const c10::DeviceGuard guard(device);
  auto dist = at::empty({n}, nbrs.options());
  auto frontier = at::empty({2 * cap}, nbrs.options());
  auto counts = at::empty({hops + 1}, nbrs.options());
  auto overflow = at::empty({1}, nbrs.options().dtype(at::kBool));
  const int err = cortex_frontier_bfs_launch(
      nbrs.data_ptr(), static_cast<int>(n), static_cast<int>(d),
      anchors.data_ptr(), static_cast<int>(a), static_cast<int>(hops),
      static_cast<int>(cap), dist.data_ptr(), frontier.data_ptr(),
      counts.data_ptr(), overflow.data_ptr(), current_stream(device));
  TORCH_CHECK(err == 0, op, ": kernel launch failed: ",
              cortex_cuda_error_string(err));
  return {dist, overflow.squeeze()};
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
  TORCH_CHECK(a >= 1 && a * n <= kMaxInt32, op, ": A=", a,
              " out of range [1, 2^31 / N)");
  // the reference's loop runs 8 rounds and masks those past `hops`
  const int64_t rounds = hops < 0 ? 0 : (hops > kMaxHops ? kMaxHops : hops);

  const c10::DeviceGuard guard(device);
  auto out = at::empty({a, n}, dist0.options());
  const int64_t nwork = rounds < 2 ? 0 : (rounds == 2 ? 1 : 2);
  auto work = at::empty({nwork * a * n}, dist0.options());
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
  m.def("bfs_relax(Tensor nbrs, Tensor dist0, int hops) -> Tensor");
}

TORCH_LIBRARY_IMPL(cortex_tpu_torch, CUDA, m) {
  m.impl("frontier_bfs", &frontier_bfs_cuda);
  m.impl("bfs_relax", &bfs_relax_cuda);
}
