// Hop-depth kernels of the device graph mirror (graph/csr.py), for sm_90a.
//
// G1, the frontier walk, in two forms that share one kernel:
// - frontier_bfs replaces the XLA program _frontier_bfs_device
//   (cortex_tpu/graph/csr.py:70): a bounded frontier walk over the
//   padded neighbor table nbrs [N, D] int32 (-1 = pad) from anchors [A]
//   (< 0 = none) for `hops` hops, returning dist [N] int32 (hop count,
//   2^30 when unreached) and an overflow flag (some hop found more than
//   `cap` new (frontier slot, column) pairs);
// - frontier_bfs_compact replaces _frontier_bfs_device_compact
//   (csr.py:120): the same walk, returning only the reached (row, depth)
//   pairs, their exact count and the overflow flag, without an [N] pass.
//
// G2 bfs_relax replaces _bfs_hops (csr.py:47), vmapped over anchors
// (csr.py:509): min(hops, 8) Jacobi rounds of
//     dist <- min(dist, min_c dist[nbrs[:, c]] + 1)
// over dist [A, N] int32, pad columns reading 2^30.
//
// What bounds them: bytes. G1 moves the frontier rows it gathers (cap x
// D x 4 bytes a hop at most) and one dist entry per pair; frontier_bfs
// also writes dist [N] once. G2 reads the whole table and dist in and
// writes dist out every round (2.56 GB of table a round at 10M x 64), and
// gathers a neighbour's depths for every live table entry. Neither does
// arithmetic worth counting.
//
// What the designs do about it:
// - G1 is one persistent cooperative launch for all hops, with a grid-wide
//   sync between hops, so a walk costs one launch and no host sync. Its
//   threads take (frontier slot, column) pairs, so the D threads of a slot
//   read its row coalesced. A pair is new when its target holds 2^30 or
//   h + 1 (no node holds h + 1 before hop h, so a target another thread
//   claimed this hop still counts, as in the reference, which counts
//   every pair whose target was unreached at the hop's start, duplicates
//   included, and keeps the duplicates in its next frontier). Every new
//   pair is counted and the first cap of them (warp-aggregated atomicAdd
//   on the hop's counter) form the next frontier. The initial frontier is
//   the anchors as given, duplicates and pads included. Only the order of
//   a truncated frontier differs from the reference's, after an overflow.
// - The compact form never touches all N rows. Its dist is a scratch that
//   the caller keeps per table, all 2^30 between calls. The lane whose
//   atomicCAS takes a row from 2^30 appends (row, depth) to the output,
//   so the reached set comes out deduplicated with an exact count; the
//   anchors are listed once each at depth 0. The output's row list is the
//   list of rows the walk set: at the end of the same launch the kernel
//   writes 2^30 back to exactly those rows, or refills all N rows when
//   more rows were reached than the output holds (the caller then falls
//   back to the exact host BFS anyway). Walks enqueued on one stream
//   therefore never see another walk's depths.
// - G2 gives each table row a group of lanes along the row (16 lanes of
//   one int4 each at D = 64), so a warp reads two whole rows as 512
//   contiguous bytes and each row is read from memory once a round; the
//   table is read with a streaming hint (__ldcs) so that its 2.56 GB a
//   round do not push the gathered depths out of L2. The group takes the
//   minimum of its lanes with __shfl_xor_sync. With more than one anchor,
//   dist is transposed once into an anchor-minor layout of tiles of 8
//   anchors ([tiles, N, 8]) before the first round and back after the
//   last, so every round gathers one 32-byte sector per neighbour for 8
//   anchors; a row's neighbours stay in registers across the tiles. The
//   rounds ping-pong between buffers (Jacobi: an in-place update would
//   give depths beyond `hops`). Offsets are 64-bit, so any A x N runs;
//   the Python wrapper cuts large anchor sets into chunks only to bound
//   the scratch buffers.
// Each launch is checked with cudaGetLastError; nothing synchronises.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "device_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kInf = 1 << 30;       // INF_DEPTH of the reference
constexpr int kThreads = 256;
constexpr int kTile = 8;            // G2: anchors in one 32-byte sector
// G1: at most this many blocks an SM (fewer blocks make a grid sync
// cheaper; 1 and 4 timed within 10 % of 2 at the 10M x 64 table)
constexpr int kWalkBlocksPerSm = 2;
// G2 cut after its table read (1: no gathers), timed by chip_smoke.py
// --profile
#ifndef CORTEX_RELAX_PARTS
#define CORTEX_RELAX_PARTS 0
#endif
constexpr bool kRelaxGathers = CORTEX_RELAX_PARTS == 0;
constexpr unsigned kFull = 0xffffffffu;

// ------------------------------------------------------------ G1

struct WalkArgs {
  const int* nbrs;
  int n, d;
  const int* anchors;
  int a_count, hops, cap;
  int* dist;           // frontier_bfs: [n] out; compact: [n] scratch
  int* frontier;       // [2 * cap]
  int* counts;         // [hops + 2]: new pairs a hop, then reached rows
  uint8_t* overflow;   // frontier_bfs: [1] out
  int* out;            // compact: [2 + 2 * out_cap]; null for frontier_bfs
  int out_cap;
};

// Appends (row, depth) to the compact output for each lane with `won`
// set: one atomicAdd a warp. Every lane of the warp calls it.
__device__ __forceinline__ void append_won(const WalkArgs& w, int* reached,
                                           bool won, int row, int depth) {
  const unsigned mask = __ballot_sync(kFull, won);
  if (mask == 0) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(mask) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(reached, __popc(mask));
  base = __shfl_sync(kFull, base, leader);
  if (won) {
    const int pos = base + __popc(mask & ((1u << lane) - 1u));
    if (pos < w.out_cap) {
      w.out[2 + pos] = row;
      w.out[2 + w.out_cap + pos] = depth;
    }
  }
}

template <bool kCompact>
__global__ void __launch_bounds__(kThreads) walk_kernel(WalkArgs w) {
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const int64_t tid = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                      threadIdx.x;
  const int64_t n_threads = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int* reached = w.counts + w.hops + 1;
  if constexpr (!kCompact) {             // dist [n] <- 2^30
    int4* d4 = reinterpret_cast<int4*>(w.dist);
    const int64_t n4 = w.n / 4;
    for (int64_t i = tid; i < n4; i += n_threads) {
      d4[i] = make_int4(kInf, kInf, kInf, kInf);
    }
    for (int64_t i = n4 * 4 + tid; i < w.n; i += n_threads) w.dist[i] = kInf;
    grid.sync();
  }
  // block 0: the counters, then hop 0's frontier (the anchors as given)
  // and the anchors' depth 0
  if (blockIdx.x == 0) {
    for (int i = threadIdx.x; i <= w.hops + 1; i += blockDim.x) {
      w.counts[i] = i == 0 ? w.a_count : 0;
    }
    __syncthreads();
    for (int i0 = 0; i0 < w.a_count; i0 += blockDim.x) {
      const int i = i0 + threadIdx.x;
      bool won = false;
      int u = -1;
      if (i < w.a_count) {
        u = w.anchors[i];
        w.frontier[i] = u;
        if (u >= 0) {
          if (kCompact) {
            won = atomicCAS(w.dist + u, kInf, 0) == kInf;
          } else {
            w.dist[u] = 0;
          }
        }
      }
      if (kCompact) append_won(w, reached, won, u, 0);
    }
  }
  grid.sync();
  // data written inside this launch is read through L2 (__ldcg): an SM's
  // L1 may hold a line from before another SM's write
  for (int h = 0; h < w.hops; ++h) {
    const int live = min(__ldcg(w.counts + h), w.cap);
    const int* f_in = w.frontier + (h & 1) * w.cap;
    int* f_out = w.frontier + ((h + 1) & 1) * w.cap;
    int* count_out = w.counts + h + 1;
    const int depth = h + 1;
    const int64_t total = static_cast<int64_t>(live) * w.d;
    // whole warps step together, so the ballots see every lane
    for (int64_t base = tid - lane; base < total; base += n_threads) {
      const int64_t idx = base + lane;
      bool fresh = false, won = false;
      int v = -1;
      if (idx < total) {
        const int64_t slot = idx / w.d;
        const int u = __ldcg(f_in + slot);
        if (u >= 0) {
          v = __ldg(w.nbrs + static_cast<int64_t>(u) * w.d + (idx - slot * w.d));
          if (v >= 0 && v < w.n) {
            const int old = atomicCAS(w.dist + v, kInf, depth);
            fresh = old == kInf || old == depth;
            won = old == kInf;
          }
        }
      }
      const unsigned mask = __ballot_sync(kFull, fresh);
      if (mask != 0) {
        const int leader = __ffs(mask) - 1;
        int first = 0;
        if (lane == leader) first = atomicAdd(count_out, __popc(mask));
        first = __shfl_sync(kFull, first, leader);
        if (fresh) {
          const int pos = first + __popc(mask & ((1u << lane) - 1u));
          if (pos < w.cap) f_out[pos] = v;
        }
      }
      if (kCompact) append_won(w, reached, won, v, depth);
    }
    grid.sync();
  }
  if (tid == 0) {
    int any = 0;
    for (int h = 1; h <= w.hops; ++h) any |= __ldcg(w.counts + h) > w.cap;
    if (kCompact) {
      w.out[0] = __ldcg(reached);
      w.out[1] = any;
    } else {
      *w.overflow = static_cast<uint8_t>(any);
    }
  }
  if (kCompact) {
    // leave the scratch as it was found: every row this walk set is in the
    // output's row list unless more rows were reached than it holds
    const int count = __ldcg(reached);
    if (count <= w.out_cap) {
      for (int64_t i = tid; i < count; i += n_threads) {
        w.dist[__ldcg(w.out + 2 + i)] = kInf;
      }
    } else {
      for (int64_t i = tid; i < w.n; i += n_threads) w.dist[i] = kInf;
    }
  }
}

// ------------------------------------------------------------ G2

// The 4 table entries a lane holds for chunk `j` of row `row` (group of
// `g` lanes, this lane `gl`): vec, one int4 at column 4 * (j * g + gl);
// scalar, columns (4 * j + k) * g + gl. Entries past d read -1.
template <bool kVec>
__device__ __forceinline__ void load_chunk(const int* row, int d, int g,
                                           int gl, int j, bool ok,
                                           int (&ids)[4]) {
  ids[0] = ids[1] = ids[2] = ids[3] = -1;
  if (!ok) return;
  if constexpr (kVec) {
    const int c = 4 * (j * g + gl);
    if (c < d) {
      const int4 q = __ldcs(reinterpret_cast<const int4*>(row + c));
      ids[0] = q.x;
      ids[1] = q.y;
      ids[2] = q.z;
      ids[3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = (4 * j + k) * g + gl;
      if (c < d) ids[k] = __ldcs(row + c);
    }
  }
}

// m[a] = min(m[a], src[v][a]) over the lane's valid entries; src is one
// tile: [n] for kW = 1, [n, 8] for kW = 8
template <int kW>
__device__ __forceinline__ void gather_min(const int* __restrict__ src,
                                           int n, const int (&ids)[4],
                                           int (&m)[kW]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int v = ids[k];
    if (static_cast<unsigned>(v) >= static_cast<unsigned>(n)) continue;
    if constexpr (!kRelaxGathers) {
      m[0] = min(m[0], v);
    } else if constexpr (kW == 1) {
      m[0] = min(m[0], __ldg(src + v));
    } else {
      const int4* p = reinterpret_cast<const int4*>(
          src + static_cast<int64_t>(v) * kW);
      const int4 lo = __ldg(p), hi = __ldg(p + 1);
      m[0] = min(m[0], lo.x);
      m[1] = min(m[1], lo.y);
      m[2] = min(m[2], lo.z);
      m[3] = min(m[3], lo.w);
      m[4] = min(m[4], hi.x);
      m[5] = min(m[5], hi.y);
      m[6] = min(m[6], hi.z);
      m[7] = min(m[7], hi.w);
    }
  }
}

// One G2 round: for every row r and tile t,
//   dst[t][r][j] = min(src[t][r][j], min_c src[t][nbrs[r, c]][j] + 1).
// A group of 2^g_log2 lanes takes a row; `chunks` chunks of 4 entries a
// lane cover its d columns (1 when d <= 4 x group, the mirror's case).
template <int kW, bool kVec>
__global__ void __launch_bounds__(kThreads)
    relax_kernel(const int* __restrict__ nbrs, int n, int d, int g_log2,
                 int chunks, const int* __restrict__ src,
                 int* __restrict__ dst, int tiles) {
  const int g = 1 << g_log2;
  const int lane = threadIdx.x & 31;
  const int gl = lane & (g - 1);
  const int rows_per_warp = 32 >> g_log2;
  const int64_t warp = (blockIdx.x * static_cast<int64_t>(blockDim.x) +
                        threadIdx.x) >> 5;
  const int64_t n_warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const int64_t plane = static_cast<int64_t>(n) * kW;
  for (int64_t base = warp * rows_per_warp; base < n;
       base += n_warps * rows_per_warp) {
    const int64_t r = base + (lane >> g_log2);
    const bool ok = r < n;
    const int* row = nbrs + r * d;
    int ids0[4];
    load_chunk<kVec>(row, d, g, gl, 0, ok, ids0);
    for (int t = 0; t < tiles; ++t) {
      const int* s = src + t * plane;
      int m[kW];
#pragma unroll
      for (int j = 0; j < kW; ++j) m[j] = kInf;
      gather_min<kW>(s, n, ids0, m);
      for (int c = 1; c < chunks; ++c) {
        int ids[4];
        load_chunk<kVec>(row, d, g, gl, c, ok, ids);
        gather_min<kW>(s, n, ids, m);
      }
      for (int off = g >> 1; off >= 1; off >>= 1) {
#pragma unroll
        for (int j = 0; j < kW; ++j) {
          m[j] = min(m[j], __shfl_xor_sync(kFull, m[j], off));
        }
      }
      if (ok) {
#pragma unroll
        for (int j = 0; j < kW; ++j) {
          if ((j & (g - 1)) == gl) {
            const int64_t at = t * plane + r * kW + j;
            // m <= 2^30, so m + 1 never wraps: the reference's int32 sum
            dst[at] = min(s[r * kW + j], m[j] + 1);
          }
        }
      }
    }
  }
}

// dist0 [a, n] -> tiles [tiles, n, 8]; anchors past a read 2^30
__global__ void to_tiles_kernel(const int* __restrict__ src, int n, int a,
                                int* __restrict__ dst, int tiles) {
  const int64_t total = static_cast<int64_t>(tiles) * n;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int t = static_cast<int>(i / n);
    const int64_t r = i - static_cast<int64_t>(t) * n;
    int v[kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const int aj = t * kTile + j;
      v[j] = aj < a ? src[static_cast<int64_t>(aj) * n + r] : kInf;
    }
    int4* p = reinterpret_cast<int4*>(dst + i * kTile);
    p[0] = make_int4(v[0], v[1], v[2], v[3]);
    p[1] = make_int4(v[4], v[5], v[6], v[7]);
  }
}

// tiles [tiles, n, 8] -> dist [a, n]
__global__ void from_tiles_kernel(const int* __restrict__ src, int n, int a,
                                  int* __restrict__ dst, int tiles) {
  const int64_t total = static_cast<int64_t>(tiles) * n;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int t = static_cast<int>(i / n);
    const int64_t r = i - static_cast<int64_t>(t) * n;
    const int4* p = reinterpret_cast<const int4*>(src + i * kTile);
    const int4 lo = p[0], hi = p[1];
    const int v[kTile] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const int aj = t * kTile + j;
      if (aj < a) dst[static_cast<int64_t>(aj) * n + r] = v[j];
    }
  }
}

int blocks_for(int64_t threads, int64_t most) {
  return static_cast<int>(
      std::max<int64_t>(1, std::min((threads + kThreads - 1) / kThreads,
                                    most)));
}

template <int kW, bool kVec>
cudaError_t relax_round(const int* nbrs, int n, int d, const int* src,
                        int* dst, int tiles, cudaStream_t s) {
  const void* fn = reinterpret_cast<const void*>(&relax_kernel<kW, kVec>);
  cortex_dev::DeviceLimits lim;
  int per_sm = 0;
  cudaError_t err = cortex_dev::fit_kernel(fn, kThreads, 0, &lim, &per_sm);
  if (err != cudaSuccess) return err;
  // lanes a row: enough for one chunk of 4 entries each, at most a warp
  const int want = (d + 3) / 4;
  int g_log2 = 0;
  while ((1 << g_log2) < want && g_log2 < 5) ++g_log2;
  const int chunks = (d + 4 * (1 << g_log2) - 1) / (4 * (1 << g_log2));
  const int64_t rows_per_block = kThreads >> g_log2;
  const int grid = blocks_for((n + rows_per_block - 1) / rows_per_block *
                                  kThreads,
                              static_cast<int64_t>(lim.sm_count) *
                                  std::max(per_sm, 1));
  relax_kernel<kW, kVec><<<grid, kThreads, 0, s>>>(nbrs, n, d, g_log2,
                                                   chunks, src, dst, tiles);
  return cudaGetLastError();
}

template <int kW>
cudaError_t relax_round_any(const int* nbrs, int n, int d, int vec4,
                            const int* src, int* dst, int tiles,
                            cudaStream_t s) {
  return vec4 ? relax_round<kW, true>(nbrs, n, d, src, dst, tiles, s)
              : relax_round<kW, false>(nbrs, n, d, src, dst, tiles, s);
}

}  // namespace

// G1, both forms. nbrs [n, d], anchors [a_count] (entries < n; the binding
// checks a_count <= cap); frontier [2 * cap] and counts [hops + 2]
// scratch. out null: dist [n] out and overflow [1] uint8 out. out
// non-null: dist is the caller's scratch (all 2^30, left so) and out
// [2 + 2 * out_cap] receives (reached count, overflow, rows, depths).
// 0 or a cudaError_t.
extern "C" int cortex_frontier_walk_launch(const void* nbrs, int n, int d,
                                           const void* anchors, int a_count,
                                           int hops, int cap, void* dist,
                                           void* frontier, void* counts,
                                           void* overflow, void* out,
                                           int out_cap, void* stream) {
  WalkArgs w{static_cast<const int*>(nbrs),
             n,
             d,
             static_cast<const int*>(anchors),
             a_count,
             hops,
             cap,
             static_cast<int*>(dist),
             static_cast<int*>(frontier),
             static_cast<int*>(counts),
             static_cast<uint8_t*>(overflow),
             static_cast<int*>(out),
             out_cap};
  const bool compact = out != nullptr;
  const void* fn = compact ? reinterpret_cast<const void*>(&walk_kernel<true>)
                           : reinterpret_cast<const void*>(&walk_kernel<false>);
  cortex_dev::DeviceLimits lim;
  int per_sm = 0;
  cudaError_t err = cortex_dev::fit_kernel(fn, kThreads, 0, &lim, &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  // every block must be resident at once (grid-wide syncs)
  const int64_t work = std::max<int64_t>(
      static_cast<int64_t>(cap) * d, compact ? 0 : n / 4);
  const int grid = blocks_for(
      work, static_cast<int64_t>(lim.sm_count) *
                std::min(per_sm, kWalkBlocksPerSm));
  void* args[] = {&w};
  err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// G2. nbrs [n, d], dist0 [a_count, n] in, out [a_count, n]. work: for
// a_count == 1, min(rounds - 1, 2) buffers of n ints (null when rounds <
// 2); for a_count > 1, two buffers of tiles x n x 8 ints, tiles =
// ceil(a_count / 8). vec4: rows are 16-byte aligned and d % 4 == 0.
// 0 or a cudaError_t.
extern "C" int cortex_bfs_relax_launch(const void* nbrs, int n, int d,
                                       int vec4, const void* dist0,
                                       int a_count, int rounds, void* out,
                                       void* work, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* table = static_cast<const int*>(nbrs);
  int* w = static_cast<int*>(work);
  if (rounds == 0) {
    return cudaMemcpyAsync(out, dist0,
                           static_cast<int64_t>(n) * a_count * sizeof(int),
                           cudaMemcpyDeviceToDevice, s);
  }
  cudaError_t err;
  if (a_count == 1) {
    const int* src = static_cast<const int*>(dist0);
    for (int r = 0; r < rounds; ++r) {
      int* dst = r == rounds - 1 ? static_cast<int*>(out)
                                 : w + static_cast<int64_t>(r % 2) * n;
      err = relax_round_any<1>(table, n, d, vec4, src, dst, 1, s);
      if (err != cudaSuccess) return err;
      src = dst;
    }
    return cudaSuccess;
  }
  const int tiles = (a_count + kTile - 1) / kTile;
  const int64_t plane = static_cast<int64_t>(tiles) * n * kTile;
  cortex_dev::DeviceLimits lim;
  err = cortex_dev::device_limits(&lim);
  if (err != cudaSuccess) return err;
  const int grid = blocks_for(static_cast<int64_t>(tiles) * n,
                              static_cast<int64_t>(lim.sm_count) * 8);
  to_tiles_kernel<<<grid, kThreads, 0, s>>>(static_cast<const int*>(dist0),
                                            n, a_count, w, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  for (int r = 0; r < rounds; ++r) {
    err = relax_round_any<kTile>(table, n, d, vec4, w + (r % 2) * plane,
                                 w + ((r + 1) % 2) * plane, tiles, s);
    if (err != cudaSuccess) return err;
  }
  from_tiles_kernel<<<grid, kThreads, 0, s>>>(w + (rounds % 2) * plane, n,
                                              a_count,
                                              static_cast<int*>(out), tiles);
  return cudaGetLastError();
}
