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
//   probe     [B, p]    i32    probed cluster ids (any order, repeats
//                              allowed; an id outside [0, C) scores its
//                              whole segment as empty: NEG_INF, row -1)
//   qi8       [B, d]    int8   quantized queries
//   ak [16] / aa [1] / ex [64] i32 filter lists, -1 = filter off / pad
// Output: scores [B, p*L] f32 and rows [B, p*L] i32 (the raw slot rows),
// column j*L + l for slot l of probe[b, j].
//
// What bounds it: bytes. The function must read each distinct probed
// list once (L*d bytes: 1.0 GB at batch 64 with nprobe 128 of 1,024
// lists of 1,280 x 768) and write 8 bytes per output slot, against
// 2*d int8 operations per (query, slot) that the int8 tensor cores do
// in far less time. So the design reads each probed list from device
// memory once per chunk of at most 64 of the queries that probe it (once
// per batch whenever no more than 64 queries probe it):
//  1. probe_plan_kernel (one block) inverts the probes on the device: a
//     counting sort of the (b, j) pairs by list (histogram, exclusive
//     scan, scatter; the per-list counts in shared memory up to
//     kPlanSmemLists lists, past it in the scratch buffer) and a table of
//     chunks (list, first sorted pair, count <= qcap). Invalid ids write
//     their segments as empty here.
//     Nothing returns to the host: the scan reads the number of chunks
//     from device memory, so a call never waits on the device.
//  2. probed_scan_kernel: a persistent grid over the work items (chunk,
//     tile of kTile slots); each block takes a contiguous span of items,
//     so it loads a chunk's queries into shared memory once for all of
//     the chunk's tiles it scans. A tile's rows stream through a
//     kStages-deep ring of 128-byte K slices (cp.async.cg, 8 threads on
//     a row's 128 contiguous bytes, XOR-swizzled so that ldmatrix reads
//     are free of bank conflicts; rows of any other d are assembled
//     from bytes, zero-padded). Small batches get small chunks (qcap),
//     so more blocks fit on an SM and more bytes are in flight.
//  3. mma.sync m16n8k32 s8 x s8 -> s32 puts the slots on M (16 a warp)
//     and the chunk's queries on N (8 a fragment): a list that one query
//     probes wastes 7 of 8 columns, not 15 of 16 rows.
//  4. The epilogue computes each slot's liveness / kind / agent /
//     exclusion mask and rinv once, applies them to every query of the
//     chunk, and writes scores[b, j*L + l] in 32-byte runs along l.
//
// Exactness: the int8 tensor cores' int32 sum is exact; it converts to
// the same f32 value as the exact f32 sum of the plain version (|sum| <=
// d * 127^2 < 2^24 for d <= 1040), and the same single rounded multiply
// by rinv follows (__fmul_rn), so scores are bit-identical to
// probed_scores_plain.
//
// The PyTorch op binding lives in ivf_gather_op.cpp, so this file never
// includes PyTorch's headers and nvcc's device pass stays fast.

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

#include "device_common.cuh"

namespace {

using namespace cortex_dev;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 16 * kWarps;      // slots per work item, 16 a warp
constexpr int kSlice = 128;             // bytes of K per ring stage
constexpr int kStages = 3;
constexpr int kMaxQ = 64;               // queries per chunk, at most
constexpr int kFrags = kMaxQ / 8;       // n-fragments of 8 queries
constexpr int kMaxKinds = 16;
constexpr int kMaxExclude = 64;
constexpr int kNoFilter = -1;
constexpr float kNegInf = -1e30f;
constexpr int kPlanThreads = 1024;
constexpr int kPlanLoads = 8;           // probe ids a plan thread loads at once
constexpr int kHeader = 4;              // plan ints before the chunk table
constexpr int kPlanSmemLists = 32768;   // per-list counts in shared memory

// Chunks the plan can make: every chunk but a list's last is full.
int64_t max_chunks(int64_t n_pairs, int64_t n_clusters, int qcap) {
  return (n_pairs + qcap - 1) / qcap + std::min(n_clusters, n_pairs);
}

// Queries per chunk: the batch rounded up to 16 (an ldmatrix.x4 reads
// two fragments of 8), at most kMaxQ.
int chunk_queries(int b) {
  return std::min(kMaxQ, std::max(16, (b + 15) / 16 * 16));
}

// The plan, in one int32 buffer: [0] the number of chunks; from kHeader
// the chunk table [max_chunks][3] (list, first sorted pair, count); then
// the pairs b * p + j sorted by list [n_pairs] (invalid ones from the
// end); then room for the per-list counts [C]. The counts, later the
// scatter cursors, live in shared memory while C <= kPlanSmemLists, so
// the histogram and the scatter are shared-memory atomics; past that
// (kGlobalCounts) in that room, with global atomics.
template <bool kGlobalCounts>
__global__ void __launch_bounds__(kPlanThreads) probe_plan_kernel(
    const int32_t* __restrict__ probe, int n_pairs, int n_clusters,
    int qcap, int l_count, int32_t* __restrict__ plan, int64_t n_table,
    float* __restrict__ scores, int32_t* __restrict__ rows_out) {
  extern __shared__ int count_s[];                    // [n_clusters]
  __shared__ int n_inv;
  __shared__ unsigned long long warp_sum[kPlanThreads / 32];
  int32_t* chunks = plan + kHeader;
  int32_t* pairs = chunks + 3 * n_table;
  int* count = kGlobalCounts ? pairs + n_pairs : count_s;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) n_inv = 0;
  for (int c = tid; c < n_clusters; c += kPlanThreads) count[c] = 0;
  __syncthreads();
  for (int base = 0; base < n_pairs; base += kPlanLoads * kPlanThreads) {
    int c[kPlanLoads];
#pragma unroll
    for (int u = 0; u < kPlanLoads; ++u) {
      const int i = base + u * kPlanThreads + tid;
      c[u] = i < n_pairs ? __ldg(probe + i) : 0;
    }
#pragma unroll
    for (int u = 0; u < kPlanLoads; ++u) {
      const int i = base + u * kPlanThreads + tid;
      if (i >= n_pairs) break;
      if (c[u] >= 0 && c[u] < n_clusters) {
        atomicAdd(count + c[u], 1);
      } else {
        pairs[n_pairs - 1 - atomicAdd(&n_inv, 1)] = i;
      }
    }
  }
  __syncthreads();

  // exclusive scan over the lists of (pairs, chunks), packed in 64 bits;
  // thread tid owns lists [c0, c1)
  const int per = (n_clusters + kPlanThreads - 1) / kPlanThreads;
  const int c0 = min(n_clusters, tid * per);
  const int c1 = min(n_clusters, c0 + per);
  unsigned long long mine = 0;
  for (int c = c0; c < c1; ++c) {
    const int n = count[c];
    mine += (static_cast<unsigned long long>(n) << 32) |
            static_cast<unsigned>((n + qcap - 1) / qcap);
  }
  unsigned long long incl = mine;
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned long long y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    unsigned long long w = warp_sum[lane];
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned long long y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    warp_sum[lane] = w;
  }
  __syncthreads();
  const unsigned long long excl =
      incl - mine + (warp > 0 ? warp_sum[warp - 1] : 0ull);
  int pos = static_cast<int>(excl >> 32);
  int t = static_cast<int>(excl & 0xffffffffull);
  for (int c = c0; c < c1; ++c) {
    const int n = count[c];
    count[c] = pos;                               // the scatter cursor
    for (int k = 0; k < n; k += qcap) {
      chunks[3 * t] = c;
      chunks[3 * t + 1] = pos + k;
      chunks[3 * t + 2] = min(qcap, n - k);
      ++t;
    }
    pos += n;
  }
  if (tid == kPlanThreads - 1) plan[0] = t;       // the total, inclusive
  __syncthreads();
  for (int base = 0; base < n_pairs; base += kPlanLoads * kPlanThreads) {
    int c[kPlanLoads];
#pragma unroll
    for (int u = 0; u < kPlanLoads; ++u) {
      const int i = base + u * kPlanThreads + tid;
      c[u] = i < n_pairs ? __ldg(probe + i) : -1;
    }
#pragma unroll
    for (int u = 0; u < kPlanLoads; ++u) {
      if (c[u] >= 0 && c[u] < n_clusters) {
        pairs[atomicAdd(count + c[u], 1)] = base + u * kPlanThreads + tid;
      }
    }
  }
  __syncthreads();

  // an invalid probe never reads the layout: its segment scores as empty
  const int64_t n_fill = static_cast<int64_t>(n_inv) * l_count;
  for (int64_t e = tid; e < n_fill; e += kPlanThreads) {
    const int k = static_cast<int>(e / l_count);
    const int l = static_cast<int>(e - static_cast<int64_t>(k) * l_count);
    const int64_t o =
        static_cast<int64_t>(pairs[n_pairs - 1 - k]) * l_count + l;
    scores[o] = kNegInf;
    rows_out[o] = -1;
  }
}

struct ScanArgs {
  const int8_t* emb;
  const float* rinv;
  const int32_t* slot_rows;
  const int32_t* kind_sl;
  const int32_t* agent_sl;
  const int8_t* qi8;
  const int32_t* ak;
  const int32_t* aa;
  const int32_t* ex;
  const int32_t* plan;      // [0]: the number of chunks
  const int32_t* chunks;    // [n][3]: list, first sorted pair, count
  const int32_t* pairs;     // b * p + j, sorted by list
  float* scores;
  int32_t* rows;
  int p, l_count, d, n_slices, n_tiles, qcap;
};

template <bool kFiltered, bool kAligned>
__global__ void __launch_bounds__(kThreads, 2)
    probed_scan_kernel(const ScanArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int pair_s[kMaxQ];
  __shared__ int ak_s[kMaxKinds];
  __shared__ int ex_s[kMaxExclude];
  __shared__ int aa_s;
  const int dpad = a.n_slices * kSlice;
  unsigned char* qsm = smem;                          // [qcap][dpad]
  unsigned char* ring = qsm + a.qcap * dpad;  // [kStages][kTile][kSlice]
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  if (kFiltered) {
    if (tid < kMaxKinds) ak_s[tid] = a.ak[tid];
    if (tid < kMaxExclude) ex_s[tid] = a.ex[tid];
    if (tid == 0) aa_s = a.aa[0];
  }

  // this block's contiguous span of work items (chunk, tile)
  const int64_t total = static_cast<int64_t>(__ldg(a.plan)) * a.n_tiles;
  const int64_t per = (total + gridDim.x - 1) / gridDim.x;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * per;
  const int64_t i1 = total < i0 + per ? total : i0 + per;
  if (i0 >= i1) return;
  const int steps = static_cast<int>((i1 - i0) * a.n_slices);

  // one pipeline step: slice `step % n_slices` of item i0 + step /
  // n_slices into ring stage `step % kStages`
  auto load_step = [&](int step) {
    const int64_t item = i0 + step / a.n_slices;
    const int slice = step % a.n_slices;
    const int t = static_cast<int>(item / a.n_tiles);
    const int tile = static_cast<int>(item - static_cast<int64_t>(t) *
                                                 a.n_tiles);
    const int64_t slot0 = static_cast<int64_t>(__ldg(a.chunks + 3 * t)) *
                              a.l_count + tile * kTile;
    unsigned char* st = ring + (step % kStages) * (kTile * kSlice);
#pragma unroll
    for (int j = 0; j < (kTile * 8) / kThreads; ++j) {
      const int u = tid + j * kThreads;
      const int r = u >> 3;
      const int c = u & 7;
      const bool in = tile * kTile + r < a.l_count;
      const int k0 = slice * kSlice + c * 16;
      unsigned char* dst = st + swz(r, c, kSlice);
      if (kAligned) {
        const bool ok = in && k0 < a.d;
        cp_async16(dst, ok ? a.emb + (slot0 + r) * a.d + k0 : a.emb,
                   ok ? 16 : 0);
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        if (in) {
          const int8_t* rp = a.emb + (slot0 + r) * a.d + k0;
          for (int x = 0; x < 16 && k0 + x < a.d; ++x) {
            w[x >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(rp[x]))
                         << (8 * (x & 3));
          }
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  };

  int acc[kFrags][4];
#pragma unroll
  for (int f = 0; f < kFrags; ++f)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[f][r] = 0;
  int cur = -1;            // the chunk whose queries sit in shared memory
  int list = 0, n_q = 0, nf = 0;
  // this thread's slots of the tile, 16 warp + lane / 4 (+ 8), and their
  // planes, loaded at the tile's first slice and used in its epilogue
  int ls[2], rw[2], kc[2], ag[2];
  float ri[2];

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_step(s);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    const int64_t item = i0 + step / a.n_slices;
    const int slice = step % a.n_slices;
    const int t = static_cast<int>(item / a.n_tiles);
    const int tile = static_cast<int>(item - static_cast<int64_t>(t) *
                                                 a.n_tiles);
    if (t != cur) {
      // a new chunk: once every warp is done with the last one's queries,
      // load this one's, zero-padded to whole 128-byte slices
      __syncthreads();
      cur = t;
      list = __ldg(a.chunks + 3 * t);
      const int first = __ldg(a.chunks + 3 * t + 1);
      n_q = __ldg(a.chunks + 3 * t + 2);
      nf = (n_q + 7) >> 3;
      if (tid < n_q) pair_s[tid] = __ldg(a.pairs + first + tid);
      const int qchunks = dpad / 16;
      for (int u = tid; u < n_q * qchunks; u += kThreads) {
        const int qr = u / qchunks;
        const int c = u - qr * qchunks;
        const int k0 = c * 16;
        const int b = __ldg(a.pairs + first + qr) / a.p;
        const int8_t* qp = a.qi8 + static_cast<int64_t>(b) * a.d + k0;
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        if (kAligned) {
          if (k0 < a.d) {
            const int4 x = __ldg(reinterpret_cast<const int4*>(qp));
            w[0] = x.x;
            w[1] = x.y;
            w[2] = x.z;
            w[3] = x.w;
          }
        } else {
          for (int x = 0; x < 16 && k0 + x < a.d; ++x) {
            w[x >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(qp[x]))
                         << (8 * (x & 3));
          }
        }
        *reinterpret_cast<uint4*>(qsm + swz(qr, c, dpad)) =
            make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (step + kStages - 1 < steps) load_step(step + kStages - 1);
    cp_async_commit();
    if (slice == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ls[h] = tile * kTile + 16 * warp + (lane >> 2) + 8 * h;
        const bool in = ls[h] < a.l_count;
        const int64_t s = static_cast<int64_t>(list) * a.l_count + ls[h];
        rw[h] = in ? __ldg(a.slot_rows + s) : -1;
        ri[h] = in ? __ldg(a.rinv + s) : 0.0f;
        kc[h] = kFiltered && in ? __ldg(a.kind_sl + s) : 0;
        ag[h] = kFiltered && in ? __ldg(a.agent_sl + s) : 0;
      }
    }

    // the product: A = this warp's 16 slots, B = the chunk's queries; a
    // fragment's columns past n_q hold stale queries, never written out
    const unsigned char* st = ring + (step % kStages) * (kTile * kSlice);
    const int mi = lane >> 3;
    const int mr = lane & 7;
#pragma unroll
    for (int kk = 0; kk < kSlice / 32; ++kk) {
      // A: slots 16 warp + 8 (mi % 2) + mr, K chunk 2 kk + mi / 2
      uint32_t af[4];
      ldmatrix_x4(af, st + swz(16 * warp + 8 * (mi & 1) + mr,
                               2 * kk + (mi >> 1), kSlice));
#pragma unroll
      for (int f = 0; f < kFrags; f += 2) {
        if (f < nf) {
          // B: queries 8 (f + mi / 2) + mr, K chunk 2 kk + mi % 2
          uint32_t bq[4];
          ldmatrix_x4(bq, qsm + swz(8 * (f + (mi >> 1)) + mr,
                                    8 * slice + 2 * kk + (mi & 1), dpad));
          mma_s8(acc[f], af, bq[0], bq[1]);
          if (f + 1 < nf) mma_s8(acc[f + 1], af, bq[2], bq[3]);
        }
      }
    }
    if (slice != a.n_slices - 1) continue;

    // ---- epilogue of the tile: this thread's two slots masked once,
    // then every query of the chunk
    bool ok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      bool live = rw[h] >= 0;                 // also false past L
      if (kFiltered) {
        if (ak_s[0] != kNoFilter) {
          bool kind_ok = false;
          for (int x = 0; x < kMaxKinds; ++x) kind_ok |= kc[h] == ak_s[x];
          live = live && kind_ok;
        }
        if (aa_s != kNoFilter) live = live && ag[h] == aa_s;
        // the -1 pad matches only empty slots, which liveness masks
        bool excluded = false;
        for (int x = 0; x < kMaxExclude; ++x) excluded |= rw[h] == ex_s[x];
        live = live && !excluded;
      }
      ok[h] = live;
    }
#pragma unroll
    for (int f = 0; f < kFrags; ++f) {
      if (f < nf) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = 8 * f + 2 * (lane & 3) + e;
          if (q < n_q) {
            const int64_t base = static_cast<int64_t>(pair_s[q]) * a.l_count;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (ls[h] < a.l_count) {
                a.scores[base + ls[h]] =
                    ok[h] ? __fmul_rn(__int2float_rn(acc[f][2 * h + e]), ri[h])
                          : kNegInf;
                a.rows[base + ls[h]] = rw[h];
              }
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[f][r] = 0;
    }
  }
  cp_async_wait<0>();
}

using ScanKernel = void (*)(ScanArgs);

ScanKernel scan_kernel(bool filtered, bool aligned) {
  if (filtered) {
    return aligned ? probed_scan_kernel<true, true>
                   : probed_scan_kernel<true, false>;
  }
  return aligned ? probed_scan_kernel<false, true>
                 : probed_scan_kernel<false, false>;
}

}  // namespace

// int32 scratch the launch needs for its plan (ivf_gather_op.cpp
// allocates it; no zeroing: the plan kernel writes what it reads).
extern "C" int64_t cortex_probed_scores_scratch(int b, int p,
                                                int n_clusters) {
  const int64_t n_pairs = static_cast<int64_t>(b) * p;
  return kHeader + 3 * max_chunks(n_pairs, n_clusters, chunk_queries(b)) +
         n_pairs + n_clusters;
}

// Enqueue the plan and the scan on `stream`; returns the cudaError_t of
// the launches (0 = success). The caller has checked shapes, types and
// devices; `aligned` = d % 16 == 0 with 16-byte aligned emb and qi8.
extern "C" int cortex_probed_scores_launch(
    const void* emb, const void* rinv, const void* slot_rows,
    const void* kind_sl, const void* agent_sl, const void* probe,
    const void* qi8, const void* ak, const void* aa, const void* ex,
    void* scores, void* rows, void* scratch, int b, int p, int n_clusters,
    int l_count, int d, int filtered, int aligned, void* stream) {
  if (b == 0 || p == 0 || l_count == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int qcap = chunk_queries(b);
  const int n_pairs = b * p;
  const int64_t n_table = max_chunks(n_pairs, n_clusters, qcap);
  int32_t* plan = static_cast<int32_t*>(scratch);
  const bool global_counts = n_clusters > kPlanSmemLists;
  const size_t plan_smem =
      global_counts ? 0 : static_cast<size_t>(n_clusters) * sizeof(int);
  const auto plan_kernel = global_counts ? probe_plan_kernel<true>
                                         : probe_plan_kernel<false>;
  DeviceLimits lim;
  int per_sm = 0;
  cudaError_t err = fit_kernel(reinterpret_cast<const void*>(plan_kernel),
                               kPlanThreads, plan_smem, &lim, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  plan_kernel<<<1, kPlanThreads, plan_smem, s>>>(
      static_cast<const int32_t*>(probe), n_pairs, n_clusters, qcap,
      l_count, plan, n_table, static_cast<float*>(scores),
      static_cast<int32_t*>(rows));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  ScanArgs a;
  a.emb = static_cast<const int8_t*>(emb);
  a.rinv = static_cast<const float*>(rinv);
  a.slot_rows = static_cast<const int32_t*>(slot_rows);
  a.kind_sl = static_cast<const int32_t*>(kind_sl);
  a.agent_sl = static_cast<const int32_t*>(agent_sl);
  a.qi8 = static_cast<const int8_t*>(qi8);
  a.ak = static_cast<const int32_t*>(ak);
  a.aa = static_cast<const int32_t*>(aa);
  a.ex = static_cast<const int32_t*>(ex);
  a.plan = plan;
  a.chunks = plan + kHeader;
  a.pairs = plan + kHeader + 3 * n_table;
  a.scores = static_cast<float*>(scores);
  a.rows = static_cast<int32_t*>(rows);
  a.p = p;
  a.l_count = l_count;
  a.d = d;
  a.n_slices = (d + kSlice - 1) / kSlice;
  a.n_tiles = (l_count + kTile - 1) / kTile;
  a.qcap = qcap;
  const size_t smem = static_cast<size_t>(qcap) * a.n_slices * kSlice +
                      static_cast<size_t>(kStages) * kTile * kSlice;
  const ScanKernel k = scan_kernel(filtered != 0, aligned != 0);
  err = fit_kernel(reinterpret_cast<const void*>(k), kThreads, smem, &lim,
                   &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = lim.sm_count * std::max(per_sm, 1);
  k<<<grid, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cortex_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
