// Exact fp32 host re-rank of device-scan candidates: the port's copy of
// gc_rerank_topk (cortex_tpu/native/graphcore.cpp:182-252), the same
// arithmetic and tie order, so both packages return the same rows.
//
// For each of b queries: gather its cand candidate rows from the fp32
// corpus mirror [n, d], dot with the query, and emit the top-k (scores +
// corpus rows), ties broken by candidate order (numpy's stable argsort
// of -scores). Parallel across queries; the ctypes call releases the
// GIL. valid[b*cand]: nonzero = candidate is live. Slots beyond the valid
// count get score -1e30 and row 0.
//
// Build: with host_graph.cpp into one library, g++ -O3 -march=native
// -shared -fPIC (native/__init__.py, the reference's flags), plain C ABI
// loaded with ctypes. It lives outside csrc/, so the CUDA build never
// sees it.

#include <algorithm>
#include <cstdint>
#include <thread>
#include <utility>
#include <vector>

extern "C" {

int32_t host_rerank_topk(const float* corpus, int64_t n, int32_t d,
                         const float* queries, int32_t b,
                         const int32_t* cand_rows, int32_t cand,
                         const uint8_t* valid, int32_t k,
                         float* out_scores, int32_t* out_rows) {
  int nth = static_cast<int>(std::thread::hardware_concurrency());
  if (nth <= 0) nth = 4;
  if (nth > b) nth = b;
  auto worker = [&](int32_t q0, int32_t q1) {
    std::vector<std::pair<float, int32_t>> sc(cand);
    for (int32_t qi = q0; qi < q1; ++qi) {
      const float* q = queries + static_cast<int64_t>(qi) * d;
      const int32_t* rows = cand_rows + static_cast<int64_t>(qi) * cand;
      const uint8_t* vd = valid + static_cast<int64_t>(qi) * cand;
      int32_t m = 0;
      for (int32_t c = 0; c < cand; ++c) {
        if (!vd[c]) continue;
        int64_t r = rows[c];
        if (r < 0 || r >= n) continue;
        const float* x = corpus + r * d;
        // 8 independent accumulator lanes: a single `s += x*q` chain is a
        // serial dependency the compiler may not reassociate without
        // -ffast-math; unrolling by hand keeps fp32 semantics
        // deterministic and lets it vectorize
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        float a4 = 0.f, a5 = 0.f, a6 = 0.f, a7 = 0.f;
        int32_t j = 0;
        for (; j + 8 <= d; j += 8) {
          a0 += x[j] * q[j];         a1 += x[j + 1] * q[j + 1];
          a2 += x[j + 2] * q[j + 2]; a3 += x[j + 3] * q[j + 3];
          a4 += x[j + 4] * q[j + 4]; a5 += x[j + 5] * q[j + 5];
          a6 += x[j + 6] * q[j + 6]; a7 += x[j + 7] * q[j + 7];
        }
        float s = ((a0 + a1) + (a2 + a3)) + ((a4 + a5) + (a6 + a7));
        for (; j < d; ++j) s += x[j] * q[j];
        sc[m++] = {s, c};
      }
      std::stable_sort(
          sc.begin(), sc.begin() + m,
          [](const std::pair<float, int32_t>& a,
             const std::pair<float, int32_t>& b2) {
            return a.first > b2.first;
          });
      float* os = out_scores + static_cast<int64_t>(qi) * k;
      int32_t* orow = out_rows + static_cast<int64_t>(qi) * k;
      for (int32_t j = 0; j < k; ++j) {
        if (j < m) {
          os[j] = sc[j].first;
          orow[j] = rows[sc[j].second];
        } else {
          os[j] = -1e30f;
          orow[j] = 0;
        }
      }
    }
  };
  if (nth <= 1) {
    worker(0, b);
    return 0;
  }
  std::vector<std::thread> ts;
  ts.reserve(nth);
  int32_t per = (b + nth - 1) / nth;
  for (int t = 0; t < nth; ++t) {
    int32_t q0 = t * per, q1 = std::min(b, q0 + per);
    if (q0 >= q1) break;
    ts.emplace_back(worker, q0, q1);
  }
  for (auto& t : ts) t.join();
  return 0;
}

}  // extern "C"
