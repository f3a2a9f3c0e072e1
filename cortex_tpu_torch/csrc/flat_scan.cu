// Flat-index kernels for Hopper (sm_90a): the int8 candidate scan (K1)
// and the exact fp32 candidate re-rank (K2) of the flat search path.
//
// Neither replaces a Pallas kernel: the reference runs both as XLA
// programs. K1 replaces cortex_tpu/ops/similarity.py::_quant_candidates
// (the int8 scan, descale, bias and top-`cand` selection, called with
// vector/shard.py::_build_bias's output); K2 replaces the tail of
// cortex_tpu/ops/similarity.py::cosine_topk_quant_exact (lines 239-253:
// gather the candidates' fp32 rows, exact dot, mask, top-k, pad).
//
// K1 quant_scan: scores s[b, r] = float(sum_j qi8[b, j] * emb_i8[r, j])
//   * (rinv[r] / qs[b]) + bias[r], in that order of operations, each
//   rounded once (__int2float_rn, __fdiv_rn, __fmul_rn, __fadd_rn: nvcc
//   must not fuse the multiply and the add, or the scores would differ
//   from the plain version's). The sum is the int32 sum of the int8
//   tensor cores, exact at any d.
//
//   What bounds it: the corpus, cap * d bytes, read once per group of up
//   to 64 queries (805 MB at cap 1,048,576 x 768: 0.24 ms at 3.35 TB/s),
//   against 2 * B * cap * d integer operations that the int8 tensor
//   cores do in less. The design:
//   - a persistent grid, one block per SM (more where they fit), each
//     looping over tiles of kRows rows (part, part + n_part, ..., from
//     the last) for one group of qt <= 64 queries; the group's queries
//     sit in shared memory for the whole kernel (48 KB at d = 768);
//   - each tile streams through a kStages-deep ring of 128-byte K slices
//     (cp.async.cg, 16 bytes a thread, 8 neighbouring threads on one
//     row's 128 contiguous bytes; rows of any other d are assembled from
//     bytes, zero-padded), swizzled so that ldmatrix reads are free of
//     bank conflicts;
//   - mma.sync m16n8k32 s8 x s8 -> s32: each warp takes 16 rows of the
//     tile against every query of the group (qt / 16 m-tiles);
//   - epilogue, 1: every thread descales its accumulators into a shared
//     score tile [qt][kRows], paying for the exact division only where a
//     cheap estimate can beat the query's threshold (-inf elsewhere), and
//     flags the queries that have a score above it;
//   - epilogue, 2: warp w owns queries w, w + 8, ...: for a flagged query
//     it appends the tile's scores above the threshold to the query's
//     candidate buffer (shared memory, or device memory when it does not
//     fit) and, when the buffer fills, compacts it to its exact top m
//     (up to 256 entries held in registers and the m-th found bit by bit
//     with ballots, a radix select beyond) and raises the threshold to
//     the m-th score;
//   - a shared bound: at its tiles 0, 1, 3, 7 and 15 each block
//     publishes its best score per query in device memory and raises its
//     thresholds to a lower bound of the query's cand-th best over the
//     whole corpus that the published scores prove (refresh_bounds), so
//     that after the first tiles almost no score is appended anywhere.
//   Each block writes its top m per query to partials [B, n_part, m];
//   the merge of the partials is a torch.topk in the wrapper
//   (ops/similarity.py), as the reference's merge is a separate
//   lax.top_k.
//
// K2 quant_rerank: exact f32 dots of each valid candidate's row with its
//   query (f32 FMAs: Precision.HIGHEST's class, no TF32, no bf16), then
//   the order score descending, candidate position ascending on ties;
//   the first min(k, cand) are written, padded to k. Bound by the gather
//   of B*cand rows (B*cand*d*4 bytes, ~12.6 MB at batch 64, cand 64, d
//   768), which one block per query left to a chain of latencies (one
//   row after another per warp, on B of the 132 SMs). So every candidate
//   row of a query is in flight at once: a thread block cluster of up to
//   8 blocks per query (grid.x = 8 B) spreads the rows over 64 warps,
//   each issuing a whole row's 16-byte loads before its first FMA; the
//   scores meet in the first block through distributed shared memory,
//   where warp 0 sorts up to 256 of them in registers (a bitonic sort
//   with shuffles, no block barrier per stage); larger cand (up to
//   16,384) keep the bitonic sort in shared memory.
//
// The PyTorch op binding lives in flat_scan_op.cpp, so this file never
// includes PyTorch's headers.

#include <algorithm>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "device_common.cuh"
#include "flat_scan.cuh"

namespace {

using namespace cortex_dev;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16 * kWarps;     // rows per K1 tile, 16 per warp
constexpr int kSlice = 128;            // bytes of K per pipeline stage
constexpr int kStages = 3;
constexpr int kMaxQ = 64;              // queries per K1 block
constexpr int kSPitch = kRows + 8;     // floats a query takes in the score tile
constexpr int kBins = 256;
constexpr int kMinBufSlack = 96;       // capb - m, at least (>= 32)
constexpr int kMaxBufSlack = 1024;     // capb - m, at most
constexpr int kPubChunks = 5;          // blocks that publish: 32 * kPubChunks
constexpr float kNegInf = -1e30f;

// K1 cut short, to time its parts (`chip_smoke.py --profile` builds this
// file with -DCORTEX_K1_PARTS=1 or 2): 1 ends each tile after the
// product, 2 after epilogue 1. The library built for the ops keeps 0,
// the whole kernel; a cut kernel's partials are meaningless.
#ifndef CORTEX_K1_PARTS
#define CORTEX_K1_PARTS 0
#endif
constexpr int kParts = CORTEX_K1_PARTS;

// K2's largest warp sort: up to 64 candidates sort 2 entries a lane, up
// to kWarpSortMax candidates kWarpSortMax / 32 a lane, more in shared
// memory. `chip_smoke.py --profile` builds this file with 64, 256 and
// 1024 to time the choice; the ops' library keeps 256 (a warp sort of
// 1,024 was slower than the shared-memory sort, and slow to compile).
#ifndef CORTEX_K2_WARP_SORT_MAX
#define CORTEX_K2_WARP_SORT_MAX 256
#endif
constexpr int kWarpSortMax = CORTEX_K2_WARP_SORT_MAX;
static_assert(kWarpSortMax == 64 || kWarpSortMax == 256 ||
                  kWarpSortMax == 1024,
              "CORTEX_K2_WARP_SORT_MAX is 64, 256 or 1024");

// -inf, below every score a row can get (masked rows score ~kNegInf)
__device__ __forceinline__ float minus_inf() {
  return __int_as_float(0xff800000);
}

// the order-preserving unsigned image of a float (larger float, larger
// key; -inf has the smallest key of all non-NaN values)
__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

struct ScanArgs {
  const int8_t* emb;
  const float* rinv;
  const int8_t* qi8;
  const float* qs;
  const float* bias;
  float* out_v;        // [b, n_part * m]
  int32_t* out_i;
  float* buf_v;        // [n_groups * n_part * qt * capb], or null
  int32_t* buf_i;
  uint32_t* pub;       // [n_groups * qt * (n_part + 1)], zeroed
  int b, cap, d, cand, n_slices, n_tiles, m, capb;
};

// Shared memory of a K1 block: queries, the ring of slices, the tile's
// scores, the radix histograms, per-query counts and thresholds, then
// (unless in device memory) the candidate buffers.
__host__ __device__ inline size_t scan_smem_fixed(int qt, int n_slices) {
  return static_cast<size_t>(qt) * n_slices * kSlice +
         static_cast<size_t>(kStages) * kRows * kSlice +
         static_cast<size_t>(qt) * kSPitch * sizeof(float) +
         static_cast<size_t>(kWarps) * kBins * sizeof(int) +
         4 * kMaxQ * sizeof(int);
}

// candidate buffer length per query for m candidates
__host__ __device__ inline int scan_capb(int m) {
  const int slack = m < kMinBufSlack ? kMinBufSlack : m;
  return m + (slack < kMaxBufSlack ? slack : kMaxBufSlack);
}

// Warp-wide, n <= 256: the exact top-m of the n > m entries (v, ix),
// moved to positions [0, m) in place (scores above the m-th, then the
// first of those equal to it in buffer order). Returns the m-th score.
// The entries sit in registers, 8 a lane (entry 32 j + lane); the m-th
// key is found bit by bit below the bits all keys share, counting the
// keys at or above each candidate with ballots.
__device__ float compact_top_small(float* v, int32_t* ix, int n, int m,
                                   int lane) {
  const uint32_t lt_mask = (1u << lane) - 1u;
  float sv[8];
  int32_t si[8];
  uint32_t k[8];
  uint32_t kmax = 0u, kmin = 0xffffffffu;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int p = 32 * j + lane;
    sv[j] = p < n ? v[p] : minus_inf();
    si[j] = p < n ? ix[p] : 0;
    k[j] = p < n ? order_key(sv[j]) : 0u;             // pads count last
    if (p < n) {
      kmax = max(kmax, k[j]);
      kmin = min(kmin, k[j]);
    }
  }
  kmax = __reduce_max_sync(0xffffffffu, kmax);
  kmin = __reduce_min_sync(0xffffffffu, kmin);
  const int top = kmax == kmin ? -1 : 31 - __clz(kmax ^ kmin);
  uint32_t kth = top < 0 ? kmax : kmax & ~((2u << top) - 1u);
  for (int bit = top; bit >= 0; --bit) {  // the largest key with >= m above
    const uint32_t test = kth | (1u << bit);
    int c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) c += __popc(__ballot_sync(0xffffffffu,
                                                          k[j] >= test));
    if (c >= m) kth = test;
  }
  int above = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) above += __popc(__ballot_sync(0xffffffffu,
                                                            k[j] > kth));
  const int want = m - above;           // entries equal to the m-th, kept
  __syncwarp();
  int out = 0, eq_seen = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const bool eq = 32 * j + lane < n && k[j] == kth;
    const uint32_t eqb = __ballot_sync(0xffffffffu, eq);
    const bool sel = k[j] > kth || (eq && eq_seen + __popc(eqb & lt_mask) <
                                              want);
    const uint32_t sb = __ballot_sync(0xffffffffu, sel);
    if (sel) {
      const int slot = out + __popc(sb & lt_mask);
      v[slot] = sv[j];
      ix[slot] = si[j];
    }
    out += __popc(sb);
    eq_seen += __popc(eqb);
  }
  __syncwarp();
  return key_value(kth);
}

// Warp-wide: the exact top-m of the n > m entries (v, ix), moved to
// positions [0, m) in place (scores above the m-th, then the first of
// those equal to it in buffer order). Returns the m-th score. A radix
// select over the order-preserving keys, 8 bits a pass from the highest
// bit in which the keys differ (so that the first pass spreads them).
__device__ __noinline__ float compact_top(float* v, int32_t* ix, int n,
                                          int m, int* h, int lane) {
  if (n <= 256) return compact_top_small(v, ix, n, m, lane);
  const uint32_t lt_mask = (1u << lane) - 1u;
  constexpr int kBatch = 8;             // loads in flight per lane
  uint32_t kmax = 0u, kmin = 0xffffffffu;
  for (int base = 0; base < n; base += 32 * kBatch) {
    uint32_t k[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = base + 32 * j + lane;
      k[j] = i < n ? order_key(v[i]) : 0u;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (base + 32 * j + lane < n) {
        kmax = max(kmax, k[j]);
        kmin = min(kmin, k[j]);
      }
    }
  }
  kmax = __reduce_max_sync(0xffffffffu, kmax);
  kmin = __reduce_min_sync(0xffffffffu, kmin);
  const uint32_t diff = kmax ^ kmin;
  const int passes = diff == 0u ? 0 : (32 - __clz(diff) + 7) / 8;
  uint32_t pmask = passes == 4 ? 0u : ~((1u << (8 * passes)) - 1u);
  uint32_t prefix = kmax & pmask;       // the bits every key shares
  int want = m;                         // rank inside the current bucket
  for (int shift = 8 * (passes - 1); shift >= 0; shift -= 8) {
    for (int i = lane; i < kBins; i += 32) h[i] = 0;
    __syncwarp();
    for (int base = 0; base < n; base += 32 * kBatch) {
      uint32_t k[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = base + 32 * j + lane;
        k[j] = i < n ? order_key(v[i]) : 0u;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (base + 32 * j + lane < n && (k[j] & pmask) == prefix) {
          atomicAdd(&h[(k[j] >> shift) & 0xff], 1);
        }
      }
    }
    __syncwarp();
    // lane l holds bins 255-8l .. 248-8l (descending); find the bin
    // where the count from the top reaches `want`
    int c[8];
    int tot = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c[j] = h[kBins - 1 - (8 * lane + j)];
      tot += c[j];
    }
    int incl = tot;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    const int excl = incl - tot;
    const bool here = excl < want && want <= incl;
    const int src = __ffs(__ballot_sync(0xffffffffu, here)) - 1;
    int digit = 0, next = 0;
    if (here) {
      int cum = excl;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (next == 0 && cum + c[j] >= want) {
          digit = kBins - 1 - (8 * lane + j);
          next = want - cum;
        }
        cum += c[j];
      }
    }
    digit = __shfl_sync(0xffffffffu, digit, src);
    want = __shfl_sync(0xffffffffu, next, src);
    prefix |= static_cast<uint32_t>(digit) << shift;
    pmask |= 0xffu << shift;
    __syncwarp();
  }
  // stable in-place compaction: an entry moves to a position <= its own,
  // and a batch of chunks is read whole before any of it is written
  int out = 0, eq_seen = 0;
  for (int base = 0; base < n; base += 32 * kBatch) {
    float sv[kBatch];
    int32_t si[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = base + 32 * j + lane;
      sv[j] = i < n ? v[i] : minus_inf();
      si[j] = i < n ? ix[i] : 0;
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const bool in = base + 32 * j + lane < n;
      const uint32_t k = order_key(sv[j]);
      const bool gt = in && k > prefix;
      const bool eq = in && k == prefix;
      const uint32_t eqb = __ballot_sync(0xffffffffu, eq);
      const bool sel = gt || (eq && eq_seen + __popc(eqb & lt_mask) < want);
      const uint32_t sb = __ballot_sync(0xffffffffu, sel);
      if (sel) {
        const int slot = out + __popc(sb & lt_mask);
        v[slot] = sv[j];
        ix[slot] = si[j];
      }
      out += __popc(sb);
      eq_seen += __popc(eqb);
    }
    __syncwarp();
  }
  return key_value(prefix);
}

// Warp-wide, at a refresh tile: raise the threshold of each of this
// warp's queries (q = q0 + kWarps w < nq, w < kQ) to a lower bound of the
// query's cand-th best score over the whole corpus, one key below it so
// that rows equal to it still pass. Two sources, both in device memory
// that every block of the query group reads and writes (`pub`: per
// query, n_part + 1 keys, zeroed before the launch):
// - each of the first 32 * kPubChunks blocks publishes its best score so
//   far (slot `part`), one row of its own partition: any x with at least
//   cand of these keys >= x is a bound (needs cand <= the publishers).
//   It is found bit by bit below the bits all published keys share, to
//   kBoundBits bits and at least down to bit kFloorBit, which keeps 8
//   bits of mantissa however far apart the keys lie (a block whose best
//   so far is a masked row's -1e30 beside a real score shares no bit
//   with it). A truncated x is smaller, so still a bound;
// - each block that keeps m = cand candidates raises slot n_part to its
//   threshold after a compaction: it holds cand rows at or above it.
// The keys of all the warp's queries are loaded at once.
template <int kQ>
__device__ __noinline__ void refresh_bounds(uint32_t* pub, int pstride,
                                            int n_part, int cand, int part,
                                            bool share_max, bool share_thr,
                                            float* thr, const uint32_t* bestk,
                                            int q0, int nq, int lane) {
  constexpr uint32_t kReal = 0x00800000u;   // keys above -inf's
  constexpr int kBoundBits = 8;
  constexpr int kFloorBit = 15;             // 8 bits below the exponent
  const int n_pub = min(n_part, 32 * kPubChunks);
  uint32_t key[kQ][kPubChunks];
  if (share_max) {
    if (lane == 0 && part < n_pub) {
#pragma unroll
      for (int w = 0; w < kQ; ++w) {
        const int q = q0 + kWarps * w;
        if (q < nq && bestk[q] > kReal) __stcg(pub + q * pstride + part,
                                               bestk[q]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int w = 0; w < kQ; ++w) {
      const int q = q0 + kWarps * w;
#pragma unroll
      for (int c = 0; c < kPubChunks; ++c) {
        const int i = 32 * c + lane;
        key[w][c] = q < nq && i < n_pub ? __ldcg(pub + q * pstride + i) : 0u;
      }
    }
  }
#pragma unroll
  for (int w = 0; w < kQ; ++w) {
    const int q = q0 + kWarps * w;
    if (q >= nq) break;
    uint32_t bound = 0u;
    if (share_max) {
      uint32_t hi = 0u, lo = 0xffffffffu;
      int n_real = 0;
#pragma unroll
      for (int c = 0; c < kPubChunks; ++c) {
        if (key[w][c] > kReal) {
          hi = max(hi, key[w][c]);
          lo = min(lo, key[w][c]);
        }
        n_real += __popc(__ballot_sync(0xffffffffu, key[w][c] > kReal));
      }
      if (n_real >= cand) {
        hi = __reduce_max_sync(0xffffffffu, hi);
        lo = __reduce_min_sync(0xffffffffu, lo);
        const int top = hi == lo ? 0 : 31 - __clz(hi ^ lo);
        bound = hi & ~((2u << top) - 1u);   // the bits above `top`
        const int last = max(0, min(top - kBoundBits + 1, kFloorBit));
        for (int bit = top; bit >= last; --bit) {
          const uint32_t test = bound | (1u << bit);
          int n = 0;
#pragma unroll
          for (int c = 0; c < kPubChunks; ++c) {
            n += __popc(__ballot_sync(0xffffffffu, key[w][c] >= test));
          }
          if (n >= cand) bound = test;
        }
      }
    }
    if (share_thr) bound = max(bound, __ldcg(pub + q * pstride + n_part));
    if (lane == 0 && bound > kReal) {
      thr[q] = fmaxf(thr[q], key_value(bound - 1u));
    }
  }
}

template <int MT, bool kAligned>
__global__ void __launch_bounds__(kThreads, 1)
    quant_scan_kernel(const ScanArgs a) {
  constexpr int qt = 16 * MT;
  extern __shared__ __align__(128) unsigned char smem[];
  const int dpad = a.n_slices * kSlice;
  unsigned char* qsm = smem;                                // [qt][dpad]
  unsigned char* ring = qsm + qt * dpad;       // [kStages][kRows][kSlice]
  float* stile = reinterpret_cast<float*>(ring + kStages * kRows * kSlice);
  int* hist = reinterpret_cast<int*>(stile + qt * kSPitch);
  int* cnt = hist + kWarps * kBins;                         // [kMaxQ]
  float* thr = reinterpret_cast<float*>(cnt + kMaxQ);       // [kMaxQ]
  int* flag = reinterpret_cast<int*>(thr + kMaxQ);          // [kMaxQ]
  uint32_t* bestk = reinterpret_cast<uint32_t*>(flag + kMaxQ);  // [kMaxQ]
  const int part = blockIdx.x;
  const int n_part = gridDim.x;
  const int q0 = blockIdx.y * qt;
  const int nq = min(qt, a.b - q0);
  float* bv;
  int32_t* bi;
  if (a.buf_v != nullptr) {
    const int64_t base = (static_cast<int64_t>(blockIdx.y) * n_part + part) *
                         qt * a.capb;
    bv = a.buf_v + base;
    bi = a.buf_i + base;
  } else {
    bv = reinterpret_cast<float*>(bestk + kMaxQ);
    bi = reinterpret_cast<int32_t*>(bv + qt * a.capb);
  }
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // the group's queries, zero-padded to qt x dpad, swizzled like the ring
  const int qchunks = dpad / 16;
  for (int t = tid; t < qt * qchunks; t += kThreads) {
    const int qr = t / qchunks;
    const int c = t - qr * qchunks;
    const int k0 = c * 16;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (qr < nq) {
      const int8_t* qp = a.qi8 + static_cast<int64_t>(q0 + qr) * a.d + k0;
      if (kAligned && k0 < a.d) {
        const int4 x = __ldg(reinterpret_cast<const int4*>(qp));
        w[0] = x.x;
        w[1] = x.y;
        w[2] = x.z;
        w[3] = x.w;
      } else if (!kAligned) {
        for (int j = 0; j < 16 && k0 + j < a.d; ++j) {
          w[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(qp[j]))
                       << (8 * (j & 3));
        }
      }
    }
    *reinterpret_cast<uint4*>(qsm + swz(qr, c, dpad)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
  if (tid < kMaxQ) {
    cnt[tid] = 0;
    thr[tid] = minus_inf();
    flag[tid] = 0;
    bestk[tid] = 0u;
  }
  // each thread's queries: m-tile i, half h -> query 16 i + lane / 4 + 8 h,
  // with its scale and the scale's reciprocal
  float qsr[MT][2], qrc[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = 16 * i + (lane >> 2) + 8 * h;
      qsr[i][h] = q < nq ? a.qs[q0 + q] : 1.0f;
      qrc[i][h] = __frcp_rn(qsr[i][h]);
    }
  }

  // the shared bound (see refresh_bounds): this group's published keys,
  // [qt][n_part + 1]
  const int pstride = n_part + 1;
  uint32_t* pub = a.pub + static_cast<int64_t>(blockIdx.y) * qt * pstride;
  const bool share_max = a.cand <= min(n_part, 32 * kPubChunks);
  const bool share_thr = a.m == a.cand;

  // this block's tiles part, part + n_part, ..., taken from the last:
  // the corpus hands out its free rows from the end (vector/shard.py), so
  // the rows a fresh capacity has not used yet lie at the start, masked.
  // Met after the live rows, they fall below the thresholds instead of
  // filling the candidate buffers while these are still empty.
  const int n_my = (a.n_tiles - part + n_part - 1) / n_part;
  const int total = n_my * a.n_slices;
  auto tile_of = [&](int step) {
    return part + (n_my - 1 - step / a.n_slices) * n_part;
  };

  // one pipeline step: slice `step % n_slices` of this block's tile
  // tile_of(step) into ring stage `step % kStages`
  auto load_step = [&](int step) {
    const int tile = tile_of(step);
    const int slice = step % a.n_slices;
    unsigned char* st = ring + (step % kStages) * (kRows * kSlice);
#pragma unroll
    for (int j = 0; j < (kRows * 8) / kThreads; ++j) {
      const int t = tid + j * kThreads;
      const int r = t >> 3;
      const int c = t & 7;
      const int64_t row = static_cast<int64_t>(tile) * kRows + r;
      const int k0 = slice * kSlice + c * 16;
      unsigned char* dst = st + swz(r, c, kSlice);
      if (kAligned) {
        const bool ok = row < a.cap && k0 < a.d;
        cp_async16(dst, ok ? a.emb + row * a.d + k0 : a.emb, ok ? 16 : 0);
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        if (row < a.cap) {
          const int8_t* rp = a.emb + row * a.d + k0;
          for (int b = 0; b < 16 && k0 + b < a.d; ++b) {
            w[b >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(rp[b]))
                         << (8 * (b & 3));
          }
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  };

  // the tile's rows under this thread's accumulators, with their rinv
  // and bias, loaded at the tile's first slice (used in its epilogue)
  int32_t rows[2][2];
  float ri[2][2], bs[2][2];
  int acc[MT][2][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;
  int sink = 0;                  // keeps a cut kernel's work (kParts)

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load_step(s);
    cp_async_commit();
  }
  for (int step = 0; step < total; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (step + kStages - 1 < total) load_step(step + kStages - 1);
    cp_async_commit();

    const int slice = step % a.n_slices;
    const int tile = tile_of(step);
    if (slice == 0) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int64_t row = static_cast<int64_t>(tile) * kRows +
                              16 * warp + 8 * j + 2 * (lane & 3) + e;
          const bool in = row < a.cap;
          rows[j][e] = in ? static_cast<int32_t>(row) : -1;
          ri[j][e] = in ? __ldg(a.rinv + row) : 0.0f;
          bs[j][e] = in ? __ldg(a.bias + row) : 0.0f;
        }
      }
    }
    const unsigned char* st = ring + (step % kStages) * (kRows * kSlice);
    const int mi = lane >> 3;
    const int mr = lane & 7;
#pragma unroll
    for (int kk = 0; kk < kSlice / 32; ++kk) {
      // B: rows 16 warp + 8 (mi / 2) + mr, K chunk 2 kk + mi % 2
      uint32_t bf[4];
      ldmatrix_x4(bf, st + swz(16 * warp + 8 * (mi >> 1) + mr,
                               2 * kk + (mi & 1), kSlice));
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        // A: queries 16 i + 8 (mi % 2) + mr, K chunk 2 kk + mi / 2
        uint32_t af[4];
        ldmatrix_x4(af, qsm + swz(16 * i + 8 * (mi & 1) + mr,
                                  8 * slice + 2 * kk + (mi >> 1), dpad));
        mma_s8(acc[i][0], af, bf[0], bf[1]);
        mma_s8(acc[i][1], af, bf[2], bf[3]);
      }
    }
    if (slice != a.n_slices - 1) continue;
    if (kParts == 1) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            sink ^= acc[i][j][r];
            acc[i][j][r] = 0;
          }
      continue;
    }

    // ---- epilogue of the tile, 1: the scores into the score tile. A
    // score can only beat its query's threshold t if its estimate with
    // the correctly rounded reciprocal of qs does, within a margin far
    // above the estimate's error (a few ulps of each term); only those
    // entries pay for the exact division, the rest are written as -inf.
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = 16 * i + (lane >> 2) + 8 * h;
        const float t = thr[q];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float s2[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = 2 * h + e;
            float s = minus_inf();
            if (rows[j][e] >= 0 && q < nq) {
              const float x = __int2float_rn(acc[i][j][r]);
              const float est = x * ri[j][e] * qrc[i][h];
              const float margin = (fabsf(est) + fabsf(bs[j][e])) * 0x1p-16f;
              if (est + bs[j][e] + margin > t) {
                s = __fadd_rn(__fmul_rn(x, __fdiv_rn(ri[j][e], qsr[i][h])),
                              bs[j][e]);
                if (s > t) flag[q] = 1;
              }
            }
            s2[e] = s;
            acc[i][j][r] = 0;
          }
          *reinterpret_cast<float2*>(stile + q * kSPitch + 16 * warp +
                                     8 * j + 2 * (lane & 3)) =
              make_float2(s2[0], s2[1]);
        }
      }
    __syncthreads();
    if (kParts == 2) {
      sink ^= __float_as_int(stile[tid]);
      continue;
    }
    // 2: each warp appends the scores of its own queries (q = warp mod
    // kWarps) flagged in 1 that beat their thresholds, compacting a full
    // buffer to its top m and raising the threshold on the way; no other
    // warp waits. At the refresh tiles it also raises the thresholds to
    // the shared bound.
#pragma unroll
    for (int w = 0; w < 2 * MT; ++w) {
      const int q = warp + kWarps * w;
      if (q >= nq) break;
      if (flag[q] == 0) continue;
      const float* srow = stile + q * kSPitch;
      const int64_t o = static_cast<int64_t>(q) * a.capb;
      const int64_t row0 = static_cast<int64_t>(tile) * kRows;
      float t = thr[q];
      int c = cnt[q];
      uint32_t top = 0u;
#pragma unroll
      for (int k = 0; k < kRows / 32; ++k) {
        const float v = srow[32 * k + lane];
        bool pass = v > t;
        uint32_t bal = __ballot_sync(0xffffffffu, pass);
        if (bal == 0u) continue;
        if (pass) top = max(top, order_key(v));
        if (c + __popc(bal) > a.capb) {
          __syncwarp();
          t = compact_top(bv + o, bi + o, c, a.m, hist + warp * kBins, lane);
          c = a.m;
          if (share_thr && lane == 0) {
            atomicMax(pub + q * pstride + n_part, order_key(t));
          }
          pass = v > t;
          bal = __ballot_sync(0xffffffffu, pass);
        }
        if (pass) {
          const int slot = c + __popc(bal & ((1u << lane) - 1u));
          bv[o + slot] = v;
          bi[o + slot] = static_cast<int32_t>(row0 + 32 * k + lane);
        }
        c += __popc(bal);
      }
      top = __reduce_max_sync(0xffffffffu, top);
      __syncwarp();
      if (lane == 0) {
        cnt[q] = c;
        thr[q] = t;
        flag[q] = 0;
        bestk[q] = max(bestk[q], top);
      }
    }
    const int ti = step / a.n_slices;
    if (ti < 16 && (ti & (ti + 1)) == 0) {       // tiles 0, 1, 3, 7, 15
      __syncwarp();
      refresh_bounds<2 * MT>(pub, pstride, n_part, a.cand, part, share_max,
                             share_thr, thr, bestk, warp, nq, lane);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (kParts != 0) {
    if (sink == 0x7fffffff) a.out_i[0] = sink;
    return;
  }

  // each query's top m of this partition -> partials [b, n_part, m],
  // padded with (-inf, row 0) where the partition held fewer rows
  for (int q = warp; q < nq; q += kWarps) {
    const int64_t o = static_cast<int64_t>(q) * a.capb;
    int n = min(cnt[q], a.capb);
    if (n > a.m) {
      compact_top(bv + o, bi + o, n, a.m, hist + warp * kBins, lane);
      n = a.m;
    }
    const int64_t out0 =
        (static_cast<int64_t>(q0 + q) * n_part + part) * a.m;
    for (int t = lane; t < a.m; t += 32) {
      a.out_v[out0 + t] = t < n ? bv[o + t] : minus_inf();
      a.out_i[out0 + t] = t < n ? bi[o + t] : 0;
    }
  }
}

using ScanKernel = void (*)(ScanArgs);

ScanKernel scan_kernel(int mt, bool aligned) {
  switch (mt * 2 + (aligned ? 1 : 0)) {
    case 2: return quant_scan_kernel<1, false>;
    case 3: return quant_scan_kernel<1, true>;
    case 4: return quant_scan_kernel<2, false>;
    case 5: return quant_scan_kernel<2, true>;
    case 6: return quant_scan_kernel<3, false>;
    case 7: return quant_scan_kernel<3, true>;
    case 8: return quant_scan_kernel<4, false>;
    default: return quant_scan_kernel<4, true>;
  }
}

// a before b in the final order: higher score, then lower position
__device__ __forceinline__ bool ranks_before(float va, int pa, float vb,
                                             int pb) {
  return va > vb || (va == vb && pa < pb);
}

constexpr int kRerankCluster = 8;      // blocks per query, at most
constexpr int kRerankLoads = 8;        // loads of a row in flight per lane

// The exact f32 dot of an f32 row with the query in shared memory, one
// warp: lane-strided 16-byte (kVec4) or 4-byte loads, kRerankLoads of
// them issued before the first is used, FMAs in order per lane, then a
// butterfly across the warp.
template <bool kVec4>
__device__ __forceinline__ float row_dot(const float* __restrict__ rp,
                                         const float* qf, int d, int lane) {
  float acc = 0.0f;
  if (kVec4) {
    const float4* r4 = reinterpret_cast<const float4*>(rp);
    const float4* q4 = reinterpret_cast<const float4*>(qf);
    const int n = d >> 2;
    for (int base = 0; base < n; base += 32 * kRerankLoads) {
      float4 x[kRerankLoads];
#pragma unroll
      for (int u = 0; u < kRerankLoads; ++u) {
        const int j = base + 32 * u + lane;
        x[u] = j < n ? __ldg(r4 + j) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int u = 0; u < kRerankLoads; ++u) {
        const int j = base + 32 * u + lane;
        if (j < n) {
          const float4 y = q4[j];
          acc = fmaf(x[u].x, y.x, acc);
          acc = fmaf(x[u].y, y.y, acc);
          acc = fmaf(x[u].z, y.z, acc);
          acc = fmaf(x[u].w, y.w, acc);
        }
      }
    }
  } else {
    for (int base = 0; base < d; base += 32 * kRerankLoads) {
      float x[kRerankLoads];
#pragma unroll
      for (int u = 0; u < kRerankLoads; ++u) {
        const int j = base + 32 * u + lane;
        x[u] = j < d ? __ldg(rp + j) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kRerankLoads; ++u) {
        const int j = base + 32 * u + lane;
        if (j < d) acc = fmaf(x[u], qf[j], acc);
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  return acc;
}

// Warp-wide bitonic sort of 32 kE entries (v, p) into the final order
// (score descending, position ascending); entry lane * kE + e sits in
// register e of `lane`. Stages with stride < kE compare-exchange inside
// a lane's registers, the others with lane ^ (stride / kE) by shuffles:
// no shared memory and no block barrier.
template <int kE>
__device__ __forceinline__ void warp_sort(float (&v)[kE], int (&p)[kE],
                                          int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * kE; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= kE) {
        const int ls = stride / kE;
        const bool lower = (lane & ls) == 0;
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const float ov = __shfl_xor_sync(0xffffffffu, v[e], ls);
          const int op = __shfl_xor_sync(0xffffffffu, p[e], ls);
          const bool desc = ((lane * kE + e) & size) == 0;
          // the lower entry of a descending pair keeps the one ranked first
          if (ranks_before(v[e], p[e], ov, op) != (lower == desc)) {
            v[e] = ov;
            p[e] = op;
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const int f = e ^ stride;
          if (f > e) {
            const bool desc = ((lane * kE + e) & size) == 0;
            const bool swap = desc ? ranks_before(v[f], p[f], v[e], p[e])
                                   : ranks_before(v[e], p[e], v[f], p[f]);
            if (swap) {
              const float tv = v[e];
              v[e] = v[f];
              v[f] = tv;
              const int tp = p[e];
              p[e] = p[f];
              p[f] = tp;
            }
          }
        }
      }
    }
  }
}

// K2, one thread block cluster of n_g <= kRerankCluster blocks per query
// (grid.x = n_g * B). Block g scores candidates [g per, (g + 1) per),
// one warp a row with all of the row's loads in flight, so that every
// candidate row of the query is read at once; the scores and candidate
// rows go to block 0's shared memory (distributed shared memory), and
// block 0 orders them: up to 32 kE entries in warp 0's registers (kE >
// 0), else by a bitonic sort of cand_p2 entries in shared memory.
template <bool kVec4, int kE>
__global__ void __launch_bounds__(kThreads) quant_rerank_kernel(
    const float* __restrict__ emb, const float* __restrict__ q,
    const float* __restrict__ cv, const int32_t* __restrict__ ci,
    float* __restrict__ out_v, int32_t* __restrict__ out_i, int cap, int d,
    int cand, int cand_p2, int k) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  // no block writes to block 0 before every block of the cluster runs:
  // arrive now, wait before the first remote write
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
  extern __shared__ __align__(16) float smf[];
  const int dq = (d + 3) & ~3;
  float* qf = smf;                                    // [dq]
  // this block's scores and candidate rows; in block 0, all of them
  float* val = qf + dq;                               // [cand_p2]
  int* ids = reinterpret_cast<int*>(val + cand_p2);   // [cand_p2]
  const int n_g = static_cast<int>(cluster.num_blocks());
  const int g = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / n_g;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int per = (cand + n_g - 1) / n_g;
  const int lo = min(cand, g * per);
  const int hi = min(cand, lo + per);
  const int64_t c0 = static_cast<int64_t>(b) * cand;
  // this warp's first candidate, read while the query loads
  int c = lo + warp;
  float cvv = c < hi ? cv[c0 + c] : kNegInf;
  int id = c < hi ? ci[c0 + c] : 0;
  const float* qb = q + static_cast<int64_t>(b) * d;
  for (int j = tid; j < d; j += kThreads) qf[j] = qb[j];
  __syncthreads();

  for (; c < hi; c += kWarps) {
    float s = kNegInf;
    if (cvv > kNegInf * 0.5f) {
      const int row = min(max(id, 0), cap - 1);
      s = row_dot<kVec4>(emb + static_cast<int64_t>(row) * d, qf, d, lane);
    }
    if (lane == 0) {
      val[c - lo] = s;
      ids[c - lo] = id;
    }
    if (c + kWarps < hi) {
      cvv = cv[c0 + c + kWarps];
      id = ci[c0 + c + kWarps];
    }
  }
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
  __syncthreads();
  if (g != 0) {
    float* dst_v = cluster.map_shared_rank(val, 0);
    int* dst_i = cluster.map_shared_rank(ids, 0);
    for (int x = lo + tid; x < hi; x += kThreads) {
      dst_v[x] = val[x - lo];
      dst_i[x] = ids[x - lo];
    }
  }
  cluster.sync();                          // block 0 holds every score
  if (g != 0) return;

  const int kk = min(k, cand);
  const int64_t o0 = static_cast<int64_t>(b) * k;
  if constexpr (kE > 0) {
    if (warp != 0) return;
    float v[kE];
    int p[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int i = lane * kE + e;
      v[e] = i < cand ? val[i] : minus_inf();    // padding sorts last
      p[e] = i;
    }
    warp_sort<kE>(v, p, lane);
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int i = lane * kE + e;
      if (i < kk) {
        out_v[o0 + i] = v[e];
        out_i[o0 + i] = ids[p[e]];
      }
    }
    for (int t = kk + lane; t < k; t += 32) {
      out_v[o0 + t] = kNegInf;
      out_i[o0 + t] = 0;
    }
  } else {
    int* pos = ids + cand_p2;                           // [cand_p2]
    for (int x = tid; x < cand_p2; x += kThreads) {
      if (x >= cand) val[x] = minus_inf();     // padding sorts last
      pos[x] = x;
    }
    __syncthreads();
    // bitonic sort of cand_p2 entries, descending by (score, -position)
    for (int size = 2; size <= cand_p2; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int t = tid; t < (cand_p2 >> 1); t += kThreads) {
          const int i = (t / stride) * stride * 2 + (t % stride);
          const int j = i + stride;
          const bool desc = (i & size) == 0;
          const bool swap = desc
                                ? ranks_before(val[j], pos[j], val[i], pos[i])
                                : ranks_before(val[i], pos[i], val[j], pos[j]);
          if (swap) {
            const float tv = val[i];
            val[i] = val[j];
            val[j] = tv;
            const int tp = pos[i];
            pos[i] = pos[j];
            pos[j] = tp;
          }
        }
        __syncthreads();
      }
    }
    for (int t = tid; t < k; t += kThreads) {
      if (t < kk) {
        out_v[o0 + t] = val[t];
        out_i[o0 + t] = ids[pos[t]];
      } else {
        out_v[o0 + t] = kNegInf;
        out_i[o0 + t] = 0;
      }
    }
  }
}

template <bool kVec4, int kE>
int launch_rerank(cudaStream_t stream, const void* emb, const void* q,
                  const void* cv, const void* ci, void* out_v, void* out_i,
                  int b, int cap, int d, int cand, int cand_p2, int k) {
  const auto kernel = quant_rerank_kernel<kVec4, kE>;
  // the query, then scores and rows [cand_p2] each, then (shared-memory
  // sort) positions [cand_p2]: 225 KiB at d 8192, cand 16384
  const size_t dq = static_cast<size_t>((d + 3) & ~3);
  const size_t smem = dq * sizeof(float) +
                      static_cast<size_t>(cand_p2) * (kE > 0 ? 2 : 3) * 4;
  DeviceLimits lim;
  int per_sm = 0;
  cudaError_t err = fit_kernel(reinterpret_cast<const void*>(kernel),
                               kThreads, smem, &lim, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_g = std::min(kRerankCluster, (cand + kWarps - 1) / kWarps);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(n_g);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_g) * static_cast<unsigned>(b));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const float*>(emb),
      static_cast<const float*>(q), static_cast<const float*>(cv),
      static_cast<const int32_t*>(ci), static_cast<float*>(out_v),
      static_cast<int32_t*>(out_i), cap, d, cand, cand_p2, k);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec4>
int launch_rerank_for(cudaStream_t s, const void* emb, const void* q,
                      const void* cv, const void* ci, void* out_v,
                      void* out_i, int b, int cap, int d, int cand,
                      int cand_p2, int k) {
  // warp sorts of 64 and kWarpSortMax entries; beyond, the shared-memory
  // sort
  const decltype(&launch_rerank<kVec4, 0>) launch =
      cand <= 64             ? launch_rerank<kVec4, 2>
      : cand <= kWarpSortMax ? launch_rerank<kVec4, kWarpSortMax / 32>
                             : launch_rerank<kVec4, 0>;
  return launch(s, emb, q, cv, ci, out_v, out_i, b, cap, d, cand, cand_p2, k);
}

}  // namespace

// K1's launch shape (see QuantScanPlan). Returns a cudaError_t (0 =
// success).
extern "C" int cortex_quant_scan_plan(int b, int cap, int d, int cand,
                                      int aligned, QuantScanPlan* plan) {
  DeviceLimits lim;
  cudaError_t err = device_limits(&lim);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t optin = static_cast<size_t>(lim.smem_optin);
  const int n_slices = (d + kSlice - 1) / kSlice;
  // the largest query group that fits beside the ring (64 up to d 2048)
  int qt = std::min(kMaxQ, std::max(16, (b + 15) / 16 * 16));
  while (qt > 16 && scan_smem_fixed(qt, n_slices) > optin) qt -= 16;
  if (scan_smem_fixed(qt, n_slices) > optin) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_tiles = (cap + kRows - 1) / kRows;
  const int m0 = std::min(cand, cap);
  const int capb0 = scan_capb(m0);
  const size_t bufs = static_cast<size_t>(qt) * capb0 *
                      (sizeof(float) + sizeof(int32_t));
  const bool in_smem = scan_smem_fixed(qt, n_slices) + bufs <= optin;
  const size_t smem = scan_smem_fixed(qt, n_slices) + (in_smem ? bufs : 0);
  const ScanKernel k = scan_kernel(qt / 16, aligned != 0);
  int per_sm = 0;
  err = fit_kernel(reinterpret_cast<const void*>(k), kThreads, smem, &lim,
                   &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_part = std::max(1, std::min(n_tiles, lim.sm_count *
                                                       std::max(per_sm, 1)));
  // a partition never holds more rows than its tiles: keep at most those
  const int64_t part_rows =
      static_cast<int64_t>((n_tiles + n_part - 1) / n_part) * kRows;
  const int m = static_cast<int>(std::min<int64_t>(m0, part_rows));
  plan->qt = qt;
  plan->n_groups = (b + qt - 1) / qt;
  plan->n_part = n_part;
  plan->m = m;
  plan->capb = scan_capb(m);
  plan->bufs_global = in_smem ? 0 : 1;
  plan->smem = static_cast<int>(smem);
  plan->aligned = aligned != 0 ? 1 : 0;
  return 0;
}

// K1: enqueue the scan on `stream` with the shape `plan` chose (the plan
// also raised the kernel's shared memory limit on this device); returns
// the cudaError_t of the launch. The caller has checked shapes, types and
// devices and allocated the partials and (bufs_global) the buffers.
extern "C" int cortex_quant_scan_launch(
    const QuantScanPlan* plan, const void* emb, const void* rinv,
    const void* qi8, const void* qs, const void* bias, void* out_v,
    void* out_i, void* buf_v, void* buf_i, void* pub, int b, int cap, int d,
    int cand, void* stream) {
  if (b == 0 || cap == 0) return 0;
  ScanArgs a;
  a.emb = static_cast<const int8_t*>(emb);
  a.rinv = static_cast<const float*>(rinv);
  a.qi8 = static_cast<const int8_t*>(qi8);
  a.qs = static_cast<const float*>(qs);
  a.bias = static_cast<const float*>(bias);
  a.out_v = static_cast<float*>(out_v);
  a.out_i = static_cast<int32_t*>(out_i);
  a.buf_v = plan->bufs_global ? static_cast<float*>(buf_v) : nullptr;
  a.buf_i = plan->bufs_global ? static_cast<int32_t*>(buf_i) : nullptr;
  a.pub = static_cast<uint32_t*>(pub);
  a.cand = cand;
  a.b = b;
  a.cap = cap;
  a.d = d;
  a.n_slices = (d + kSlice - 1) / kSlice;
  a.n_tiles = (cap + kRows - 1) / kRows;
  a.m = plan->m;
  a.capb = plan->capb;
  const ScanKernel k = scan_kernel(plan->qt / 16, plan->aligned != 0);
  const dim3 grid(static_cast<unsigned>(plan->n_part),
                  static_cast<unsigned>(plan->n_groups));
  k<<<grid, kThreads, static_cast<size_t>(plan->smem),
      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K2: enqueue the re-rank on `stream`; returns the cudaError_t of the
// launch. cand_p2 is cand rounded up to a power of two.
extern "C" int cortex_quant_rerank_launch(
    const void* emb, const void* q, const void* cv, const void* ci,
    void* out_v, void* out_i, int b, int cap, int d, int cand, int cand_p2,
    int k, void* stream) {
  if (b == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % 4 == 0) {
    return launch_rerank_for<true>(s, emb, q, cv, ci, out_v, out_i, b, cap,
                                   d, cand, cand_p2, k);
  }
  return launch_rerank_for<false>(s, emb, q, cv, ci, out_v, out_i, b, cap, d,
                                  cand, cand_p2, k);
}
