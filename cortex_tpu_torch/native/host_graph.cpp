// Host graph fast paths of the graph engine: the port's copies of gc_bfs,
// gc_dijkstra_maxprod, gc_components and gc_decay_sweep
// (cortex_tpu/native/graphcore.cpp:30, :79, :127 and :155), the same
// arithmetic and visiting order, so both packages return the same
// depths, parents, paths, component labels and decayed weights.
//
// GraphEngine.find_paths takes gc_bfs for unfiltered single-path
// queries (parents give the path); GraphEngine.components labels the
// undirected CSR with gc_components. gc_dijkstra_maxprod and
// gc_decay_sweep are public entry points of the native package, as in
// the reference. Python paths exist for all; the library is an
// accelerator.
//
// Build: compiled with host_rerank.cpp into one library by
// native/__init__.py (g++ -O3 -march=native -shared -fPIC), plain C ABI
// loaded with ctypes.

#include <cmath>
#include <cstdint>
#include <queue>
#include <utility>
#include <vector>

extern "C" {

// Multi-source BFS over CSR. depths[n] must be preallocated; unreached
// nodes get -1. Honors max_depth (<0 = unbounded) and max_visited
// (<=0 = unbounded; counts dequeued nodes). Returns number of nodes
// reached, or -1 when truncated by the visited budget.
int64_t gc_bfs(const int32_t* indptr, const int32_t* indices, int32_t n,
               const int32_t* sources, int32_t n_sources,
               int32_t max_depth, int64_t max_visited,
               int32_t* depths, int32_t* parents) {
  for (int32_t i = 0; i < n; ++i) depths[i] = -1;
  if (parents) for (int32_t i = 0; i < n; ++i) parents[i] = -1;
  std::vector<int32_t> frontier, next;
  frontier.reserve(256);
  for (int32_t s = 0; s < n_sources; ++s) {
    int32_t v = sources[s];
    if (v >= 0 && v < n && depths[v] < 0) {
      depths[v] = 0;
      frontier.push_back(v);
    }
  }
  int64_t reached = static_cast<int64_t>(frontier.size());
  int64_t visited = 0;
  bool truncated = false;
  int32_t depth = 0;
  while (!frontier.empty()) {
    if (max_depth >= 0 && depth >= max_depth) break;
    next.clear();
    for (int32_t u : frontier) {
      if (max_visited > 0 && ++visited > max_visited) {
        truncated = true;
        break;
      }
      for (int32_t e = indptr[u]; e < indptr[u + 1]; ++e) {
        int32_t v = indices[e];
        if (depths[v] < 0) {
          depths[v] = depth + 1;
          if (parents) parents[v] = u;
          next.push_back(v);
          ++reached;
        }
      }
    }
    if (truncated) break;
    frontier.swap(next);
    ++depth;
  }
  return truncated ? -1 : reached;
}

// Max-product shortest path (path weight = product of edge weights in
// (0,1]; maximize). Dijkstra over -log(w) equivalently expressed as
// max-heap on product. Writes the node sequence to out_path (size
// out_cap) and the product to *out_weight. Returns the path length in
// nodes, 0 if unreachable, -1 if out_cap too small.
int32_t gc_dijkstra_maxprod(const int32_t* indptr, const int32_t* indices,
                            const float* weights, int32_t n,
                            int32_t src, int32_t dst, int32_t max_len,
                            int32_t* out_path, int32_t out_cap,
                            double* out_weight) {
  if (src < 0 || src >= n || dst < 0 || dst >= n) return 0;
  std::vector<double> best(n, -1.0);
  std::vector<int32_t> prev(n, -1);
  std::vector<int32_t> hops(n, 0);
  using Item = std::pair<double, int32_t>;  // (product, node)
  std::priority_queue<Item> pq;
  best[src] = 1.0;
  pq.push({1.0, src});
  while (!pq.empty()) {
    auto [w, u] = pq.top();
    pq.pop();
    if (w < best[u]) continue;  // stale entry
    if (u == dst) break;
    if (max_len > 0 && hops[u] >= max_len) continue;
    for (int32_t e = indptr[u]; e < indptr[u + 1]; ++e) {
      int32_t v = indices[e];
      double nw = w * static_cast<double>(weights[e]);
      if (nw > best[v]) {
        best[v] = nw;
        prev[v] = u;
        hops[v] = hops[u] + 1;
        pq.push({nw, v});
      }
    }
  }
  if (best[dst] < 0.0) return 0;
  // reconstruct (dst -> src), then reverse
  std::vector<int32_t> rev;
  for (int32_t v = dst; v >= 0; v = prev[v]) {
    rev.push_back(v);
    if (v == src) break;
  }
  if (rev.back() != src) return 0;
  if (static_cast<int32_t>(rev.size()) > out_cap) return -1;
  int32_t len = static_cast<int32_t>(rev.size());
  for (int32_t i = 0; i < len; ++i) out_path[i] = rev[len - 1 - i];
  *out_weight = best[dst];
  return len;
}

// Connected components over an undirected CSR (callers must include
// both edge directions). Labels written to comp[n]; returns the
// component count.
int32_t gc_components(const int32_t* indptr, const int32_t* indices,
                      int32_t n, int32_t* comp) {
  for (int32_t i = 0; i < n; ++i) comp[i] = -1;
  std::vector<int32_t> stack;
  int32_t label = 0;
  for (int32_t s = 0; s < n; ++s) {
    if (comp[s] >= 0) continue;
    comp[s] = label;
    stack.push_back(s);
    while (!stack.empty()) {
      int32_t u = stack.back();
      stack.pop_back();
      for (int32_t e = indptr[u]; e < indptr[u + 1]; ++e) {
        int32_t v = indices[e];
        if (comp[v] < 0) {
          comp[v] = label;
          stack.push_back(v);
        }
      }
    }
    ++label;
  }
  return label;
}

// Vectorized edge-decay sweep (host fallback mirroring ops/decay.py):
// w *= exp(-rate_i * days_i); flags[i] = 2 delete, 1 prune, 0 keep.
// Returns count of flagged (non-zero) edges.
int64_t gc_decay_sweep(float* weights, const float* eff_rates,
                       const float* days, int64_t m,
                       float delete_below, float prune_below,
                       uint8_t* flags) {
  int64_t flagged = 0;
  for (int64_t i = 0; i < m; ++i) {
    float w = weights[i] * expf(-eff_rates[i] * days[i]);
    weights[i] = w;
    uint8_t f = 0;
    if (w < delete_below) f = 2;
    else if (w < prune_below) f = 1;
    flags[i] = f;
    flagged += (f != 0);
  }
  return flagged;
}

}  // extern "C"
