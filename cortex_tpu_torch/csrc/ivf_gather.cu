// IVF gather-score kernel for Hopper (sm_90a).
//
// Replaces cortex_tpu/ops/ivf_gather.py::probed_scores (the Pallas
// kernel `_kernel`): for every query b and probed cluster probe[b, j],
// score each of the cluster's L int8 slots against the int8 query,
// multiply by the slot's dequant factor rinv, and send empty slots,
// kind/agent mismatches and excluded rows to NEG_INF.
//
// Layout (cortex_tpu_torch/vector/ivf.py builds it):
//   emb       [C, L, d] int8   centered-quantized rows, zero in empty slots
//   rinv      [C, L]    f32    per-slot dequant factor
//   slot_rows [C, L]    i32    global row id, -1 for an empty slot
//   kind_sl   [C, L]    i32    kind code
//   agent_sl  [C, L]    i32    agent code
//   probe     [B, p]    i32    probed cluster ids
//   qi8       [B, d]    int8   quantized queries
//   ak [16] / aa [1] / ex [64] i32 filter lists, -1 = filter off / pad
// Output: scores [B, p*L] f32 and rows [B, p*L] i32 (the raw slot rows).
//
// What bounds it: every probed block is read once per query that probes
// it, d bytes per slot against 4 bytes of output per slot, with a
// __dp4a per 4 bytes: far below the card's compute, so the kernel is
// bound by device-memory bandwidth. This first version keeps the design
// plain: one block per (b, j), the query in shared memory as int32
// words, one warp per slot reading the row as coalesced 4-byte words,
// a shuffle reduction and a masked epilogue on lane 0. Sharing a probed
// block between the queries that probe it, wider loads and TMA are
// later work.
//
// Exactness: the int32 dot of an int8 row and an int8 query is the same
// value as the exact f32 sum the plain version computes (|sum| <=
// d * 127^2 < 2^24 for d <= 1040), and the same single multiply by rinv
// follows, so scores are bit-identical to probed_scores_plain.
//
// The PyTorch op binding lives in ivf_gather_op.cpp, so this file never
// includes PyTorch's headers and nvcc's device pass stays fast.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxKinds = 16;
constexpr int kMaxExclude = 64;
constexpr int kNoFilter = -1;
constexpr float kNegInf = -1e30f;

// Word w (4 bytes) of an int8 row. Rows start 4-byte aligned only when
// d % 4 == 0; otherwise the word is assembled from byte loads.
template <bool kAligned>
__device__ __forceinline__ int load_word(const int8_t* row, int w) {
  if (kAligned) {
    return __ldg(reinterpret_cast<const int*>(row) + w);
  }
  const unsigned char* b = reinterpret_cast<const unsigned char*>(row) + 4 * w;
  return static_cast<int>(
      static_cast<uint32_t>(__ldg(b)) |
      (static_cast<uint32_t>(__ldg(b + 1)) << 8) |
      (static_cast<uint32_t>(__ldg(b + 2)) << 16) |
      (static_cast<uint32_t>(__ldg(b + 3)) << 24));
}

template <bool kFiltered, bool kAligned>
__global__ void __launch_bounds__(kThreads) probed_scores_kernel(
    const int8_t* __restrict__ emb, const float* __restrict__ rinv,
    const int32_t* __restrict__ slot_rows,
    const int32_t* __restrict__ kind_sl,
    const int32_t* __restrict__ agent_sl,
    const int32_t* __restrict__ probe, const int8_t* __restrict__ qi8,
    const int32_t* __restrict__ ak, const int32_t* __restrict__ aa,
    const int32_t* __restrict__ ex, float* __restrict__ scores,
    int32_t* __restrict__ rows_out, int p, int n_clusters, int l_count,
    int d) {
  extern __shared__ int q_words[];            // ceil(d / 4) words
  __shared__ int ak_s[kMaxKinds];
  __shared__ int ex_s[kMaxExclude];
  __shared__ int aa_s;

  const int j = blockIdx.x;
  const int b = blockIdx.y;
  const int n_words = d >> 2;
  const int n_tail = d & 3;

  // the query, zero-padded to whole words
  const int8_t* q = qi8 + static_cast<int64_t>(b) * d;
  for (int w = threadIdx.x; w < (d + 3) / 4; w += blockDim.x) {
    uint32_t word = 0;
    for (int t = 0; t < 4; ++t) {
      const int i = 4 * w + t;
      const uint32_t byte =
          i < d ? static_cast<uint32_t>(static_cast<unsigned char>(q[i])) : 0u;
      word |= byte << (8 * t);
    }
    q_words[w] = static_cast<int>(word);
  }
  if (kFiltered) {
    if (threadIdx.x < kMaxKinds) ak_s[threadIdx.x] = ak[threadIdx.x];
    if (threadIdx.x < kMaxExclude) ex_s[threadIdx.x] = ex[threadIdx.x];
    if (threadIdx.x == 0) aa_s = aa[0];
  }
  __syncthreads();

  const int64_t out0 = (static_cast<int64_t>(b) * p + j) * l_count;
  const int cl = probe[static_cast<int64_t>(b) * p + j];
  if (cl < 0 || cl >= n_clusters) {
    // never read outside the layout: an invalid probe scores as empty
    for (int l = threadIdx.x; l < l_count; l += blockDim.x) {
      scores[out0 + l] = kNegInf;
      rows_out[out0 + l] = -1;
    }
    return;
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t slot0 = static_cast<int64_t>(cl) * l_count;
  const int8_t* q_bytes = reinterpret_cast<const int8_t*>(q_words);
  for (int l = warp; l < l_count; l += kWarps) {
    const int64_t s = slot0 + l;
    const int8_t* row = emb + s * d;
    int acc = 0;
#pragma unroll 4
    for (int w = lane; w < n_words; w += 32) {
      acc = __dp4a(load_word<kAligned>(row, w), q_words[w], acc);
    }
    if (lane < n_tail) {
      const int i = 4 * n_words + lane;
      acc += static_cast<int>(row[i]) * static_cast<int>(q_bytes[i]);
    }
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) {
      const int r = slot_rows[s];
      bool ok = r >= 0;                       // liveness
      if (kFiltered) {
        if (ak_s[0] != kNoFilter) {
          const int kc = kind_sl[s];
          bool kind_ok = false;
          for (int t = 0; t < kMaxKinds; ++t) kind_ok |= kc == ak_s[t];
          ok = ok && kind_ok;
        }
        if (aa_s != kNoFilter) ok = ok && agent_sl[s] == aa_s;
        // the -1 pad matches only empty slots, which liveness masks
        bool excluded = false;
        for (int t = 0; t < kMaxExclude; ++t) excluded |= r == ex_s[t];
        ok = ok && !excluded;
      }
      scores[out0 + l] = ok ? static_cast<float>(acc) * rinv[s] : kNegInf;
      rows_out[out0 + l] = r;
    }
  }
}

template <bool kFiltered, bool kAligned>
void launch(dim3 grid, size_t smem, cudaStream_t stream, const void* emb,
            const void* rinv, const void* slot_rows, const void* kind_sl,
            const void* agent_sl, const void* probe, const void* qi8,
            const void* ak, const void* aa, const void* ex, void* scores,
            void* rows, int p, int n_clusters, int l_count, int d) {
  probed_scores_kernel<kFiltered, kAligned><<<grid, kThreads, smem, stream>>>(
      static_cast<const int8_t*>(emb), static_cast<const float*>(rinv),
      static_cast<const int32_t*>(slot_rows),
      static_cast<const int32_t*>(kind_sl),
      static_cast<const int32_t*>(agent_sl),
      static_cast<const int32_t*>(probe), static_cast<const int8_t*>(qi8),
      static_cast<const int32_t*>(ak), static_cast<const int32_t*>(aa),
      static_cast<const int32_t*>(ex), static_cast<float*>(scores),
      static_cast<int32_t*>(rows), p, n_clusters, l_count, d);
}

}  // namespace

// Enqueue the kernel on `stream`; returns the cudaError_t of the launch
// (0 = success). The caller has checked shapes, types and devices.
extern "C" int cortex_probed_scores_launch(
    const void* emb, const void* rinv, const void* slot_rows,
    const void* kind_sl, const void* agent_sl, const void* probe,
    const void* qi8, const void* ak, const void* aa, const void* ex,
    void* scores, void* rows, int b, int p, int n_clusters, int l_count,
    int d, int filtered, void* stream) {
  if (b == 0 || p == 0 || l_count == 0) return 0;
  const dim3 grid(static_cast<unsigned>(p), static_cast<unsigned>(b));
  const size_t smem = static_cast<size_t>((d + 3) / 4) * sizeof(int);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = (d % 4) == 0;
  if (filtered) {
    if (aligned) {
      launch<true, true>(grid, smem, s, emb, rinv, slot_rows, kind_sl,
                         agent_sl, probe, qi8, ak, aa, ex, scores, rows, p,
                         n_clusters, l_count, d);
    } else {
      launch<true, false>(grid, smem, s, emb, rinv, slot_rows, kind_sl,
                          agent_sl, probe, qi8, ak, aa, ex, scores, rows, p,
                          n_clusters, l_count, d);
    }
  } else if (aligned) {
    launch<false, true>(grid, smem, s, emb, rinv, slot_rows, kind_sl,
                        agent_sl, probe, qi8, ak, aa, ex, scores, rows, p,
                        n_clusters, l_count, d);
  } else {
    launch<false, false>(grid, smem, s, emb, rinv, slot_rows, kind_sl,
                         agent_sl, probe, qi8, ak, aa, ex, scores, rows, p,
                         n_clusters, l_count, d);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cortex_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
