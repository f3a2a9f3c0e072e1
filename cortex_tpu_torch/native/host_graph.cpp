// Host graph fast paths of the graph engine: the port's copies of gc_bfs
// and gc_components (cortex_tpu/native/graphcore.cpp:30 and :127), the
// same arithmetic and visiting order, so both packages return the same
// depths, parents and component labels.
//
// GraphEngine.find_paths takes gc_bfs for unfiltered single-path
// queries (parents give the path); GraphEngine.components labels the
// undirected CSR with gc_components. Python paths exist for both; the
// library is an accelerator.
//
// Build: compiled with host_rerank.cpp into one library by
// native/__init__.py (g++ -O3 -march=native -shared -fPIC), plain C ABI
// loaded with ctypes.

#include <cstdint>
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

}  // extern "C"
