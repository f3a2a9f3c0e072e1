// Hop-depth kernels of the device graph mirror (graph/csr.py), for sm_90a.
//
// G1 frontier_bfs replaces the XLA program _frontier_bfs_device
// (cortex_tpu/graph/csr.py:70): a bounded frontier walk over the padded
// neighbor table nbrs [N, D] int32 (-1 = pad) from anchors [A] (< 0 =
// none) for `hops` hops, returning dist [N] int32 (hop count, 2^30 when
// unreached) and an overflow flag (some hop found more than `cap` new
// (frontier slot, column) pairs).
//
// G2 bfs_relax replaces _bfs_hops (csr.py:47), vmapped over anchors
// (csr.py:509): min(hops, 8) Jacobi rounds of
//     dist <- min(dist, min_c dist[nbrs[:, c]] + 1)
// over dist [A, N] int32, pad columns reading 2^30.
//
// What bounds them: bytes. G1 moves the frontier rows it gathers (cap x
// D x 4 bytes a hop at most), one dist entry per pair and dist [N] once
// (the fill); G2 reads the whole table and dist in and writes dist out
// every round (2.56 GB of table a round at 10M x 64). Neither does
// arithmetic worth counting.
//
// What the designs do about it:
// - G1 launches one kernel per hop over cap x D threads, a thread per
//   (frontier slot, column), so the D threads of a slot read its row
//   coalesced; threads past the live frontier leave at once (whole
//   blocks before touching memory). The live size is read from device
//   memory (counts[h]), so the hops run back to back with no host sync.
//   Only the dist [N] fill touches every row.
// - G1 reproduces the reference's overflow flag exactly. The reference
//   counts every (slot, column) pair whose target was unreached at the
//   start of the hop, duplicates included, and keeps the duplicates in
//   its next frontier. Here a pair is new when dist[v] is 2^30 or h + 1
//   (no node holds h + 1 before hop h, so a target another thread
//   already claimed this hop still counts, as in the reference), every
//   new pair is counted, and the first cap of them (warp-aggregated
//   atomicAdd on the hop's counter) form the next frontier. The
//   initial frontier is the anchors as given, duplicates and pads
//   included. Only the order of a truncated frontier differs, after
//   an overflow, when every caller discards dist.
// - G2 runs a thread per row over up to 8 anchors at a time, so a row's
//   D neighbours are read once a round for 8 anchors (16-byte loads
//   when the row allows). The rounds ping-pong between buffers (Jacobi:
//   an in-place update would give depths beyond `hops`). Between the
//   first and the last round dist lives anchor-minor ([N, A]), so a
//   neighbour's A depths share one 32-byte sector instead of A sectors
//   N x 4 bytes apart; the first round reads dist0 [A, N] and the last
//   writes dist [A, N] in place of two transposes.
// Each launch is checked with cudaGetLastError; nothing synchronises.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kInf = 1 << 30;       // INF_DEPTH of the reference
constexpr int kThreads = 256;
constexpr int kAnchorTile = 8;      // G2: anchors a thread keeps in registers

__global__ void fill_kernel(int* __restrict__ dist, int64_t n) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    dist[i] = kInf;
  }
}

// One block: hop 0's frontier is the anchors as given; anchor rows get
// depth 0; the hop counters start at (A, 0, ..., 0).
__global__ void seed_kernel(int* __restrict__ dist,
                            const int* __restrict__ anchors, int a_count,
                            int* __restrict__ frontier,
                            int* __restrict__ counts, int hops) {
  for (int i = threadIdx.x; i < a_count; i += blockDim.x) {
    const int u = anchors[i];
    frontier[i] = u;
    if (u >= 0) dist[u] = 0;
  }
  for (int i = threadIdx.x; i <= hops; i += blockDim.x) {
    counts[i] = i == 0 ? a_count : 0;
  }
}

__global__ void expand_kernel(const int* __restrict__ nbrs, int n, int d,
                              int* dist, const int* __restrict__ f_in,
                              const int* __restrict__ count_in,
                              int* __restrict__ f_out,
                              int* __restrict__ count_out, int cap,
                              int depth) {
  const int live = min(*count_in, cap);
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x;
  if (first >= static_cast<int64_t>(live) * d) return;   // whole block
  const int64_t idx = first + threadIdx.x;
  const int64_t slot = idx / d;
  bool fresh = false;
  int v = -1;
  if (slot < live) {
    const int u = f_in[slot];
    if (u >= 0) {
      v = __ldg(nbrs + static_cast<int64_t>(u) * d + (idx - slot * d));
      if (v >= 0 && v < n) {
        const int dv = dist[v];
        fresh = dv == kInf || dv == depth;
      }
    }
  }
  if (fresh) atomicMin(dist + v, depth);
  // every lane of the warp is still here: claim next-frontier slots with
  // one atomicAdd a warp
  const unsigned mask = __ballot_sync(0xffffffffu, fresh);
  if (mask == 0) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(mask) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(count_out, __popc(mask));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (fresh) {
    const int pos = base + __popc(mask & ((1u << lane) - 1u));
    if (pos < cap) f_out[pos] = v;
  }
}

__global__ void overflow_kernel(const int* __restrict__ counts, int hops,
                                int cap, uint8_t* __restrict__ overflow) {
  uint8_t any = 0;
  for (int h = 1; h <= hops; ++h) any |= counts[h] > cap;
  *overflow = any;
}

// One G2 round. src / dst element (row r, anchor a) lives at
// r * row_stride + a * anchor_stride: [A, N] is (1, N), [N, A] is (A, 1).
__global__ void relax_kernel(const int* __restrict__ nbrs, int n, int d,
                             int vec4, const int* __restrict__ src,
                             int64_t s_row, int64_t s_anchor,
                             int* __restrict__ dst, int64_t d_row,
                             int64_t d_anchor, int a_count) {
  const int64_t r = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (r >= n) return;
  const int* row = nbrs + r * d;
  for (int a0 = 0; a0 < a_count; a0 += kAnchorTile) {
    const int na = min(kAnchorTile, a_count - a0);
    int m[kAnchorTile];
#pragma unroll
    for (int j = 0; j < kAnchorTile; ++j) m[j] = kInf;
    auto visit = [&](int v) {
      if (static_cast<unsigned>(v) >= static_cast<unsigned>(n)) return;
      const int* s = src + v * s_row + a0 * s_anchor;
#pragma unroll
      for (int j = 0; j < kAnchorTile; ++j) {
        if (j < na) m[j] = min(m[j], s[j * s_anchor]);
      }
    };
    if (vec4) {
      const int4* row4 = reinterpret_cast<const int4*>(row);
      for (int c = 0; c < d / 4; ++c) {
        const int4 q = __ldg(row4 + c);
        visit(q.x);
        visit(q.y);
        visit(q.z);
        visit(q.w);
      }
    } else {
      for (int c = 0; c < d; ++c) visit(__ldg(row + c));
    }
#pragma unroll
    for (int j = 0; j < kAnchorTile; ++j) {
      if (j < na) {
        const int own = src[r * s_row + (a0 + j) * s_anchor];
        // m <= 2^30, so m + 1 never wraps: the reference's int32 sum
        dst[r * d_row + (a0 + j) * d_anchor] = min(own, m[j] + 1);
      }
    }
  }
}

int blocks_for(int64_t threads) {
  return static_cast<int>((threads + kThreads - 1) / kThreads);
}

}  // namespace

// G1. nbrs [n, d], anchors [a_count] (entries < n; the binding checks
// a_count <= cap), dist [n] out; frontier [2 * cap] and counts
// [hops + 1] scratch; overflow [1] uint8 out. 0 or a cudaError_t.
extern "C" int cortex_frontier_bfs_launch(const void* nbrs, int n, int d,
                                          const void* anchors, int a_count,
                                          int hops, int cap, void* dist,
                                          void* frontier, void* counts,
                                          void* overflow, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* dist_p = static_cast<int*>(dist);
  int* f = static_cast<int*>(frontier);
  int* c = static_cast<int*>(counts);
  fill_kernel<<<std::min(blocks_for(n), 132 * 16), kThreads, 0, s>>>(dist_p,
                                                                     n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  seed_kernel<<<1, kThreads, 0, s>>>(dist_p,
                                     static_cast<const int*>(anchors),
                                     a_count, f, c, hops);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int grid = blocks_for(static_cast<int64_t>(cap) * d);
  for (int h = 0; h < hops; ++h) {
    expand_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const int*>(nbrs), n, d, dist_p, f + (h % 2) * cap,
        c + h, f + ((h + 1) % 2) * cap, c + h + 1, cap, h + 1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  overflow_kernel<<<1, 1, 0, s>>>(c, hops, cap,
                                  static_cast<uint8_t*>(overflow));
  return cudaGetLastError();
}

// G2. nbrs [n, d], dist0 [a_count, n] in, out [a_count, n]; work holds
// min(rounds - 1, 2) buffers of n * a_count ints (null when rounds < 2).
// vec4: rows are 16-byte aligned and d % 4 == 0. 0 or a cudaError_t.
extern "C" int cortex_bfs_relax_launch(const void* nbrs, int n, int d,
                                       int vec4, const void* dist0,
                                       int a_count, int rounds, void* out,
                                       void* work, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t plane = static_cast<int64_t>(n) * a_count;
  if (rounds == 0) {
    return cudaMemcpyAsync(out, dist0, plane * sizeof(int),
                           cudaMemcpyDeviceToDevice, s);
  }
  int* w = static_cast<int*>(work);
  const int* src = static_cast<const int*>(dist0);
  int64_t s_row = 1, s_anchor = n;                  // [A, N]
  for (int r = 0; r < rounds; ++r) {
    const bool last = r == rounds - 1;
    int* dst = last ? static_cast<int*>(out) : w + (r % 2) * plane;
    const int64_t d_row = last ? 1 : a_count;
    const int64_t d_anchor = last ? n : 1;
    relax_kernel<<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const int*>(nbrs), n, d, vec4, src, s_row, s_anchor,
        dst, d_row, d_anchor, a_count);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    src = dst;
    s_row = d_row;
    s_anchor = d_anchor;
  }
  return cudaSuccess;
}
