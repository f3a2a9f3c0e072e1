// kNN-graph block kernel N1 for Hopper (sm_90a).
//
// Replaces cortex_tpu/vector/knn_graph.py::_block_knn (:105), the XLA
// program of the IVF index's kNN-graph build: for every cluster c of a
// chunk and every slot i of it, score i against every slot j of the same
// cluster,
//
//   s[i, j] = (float(emb[c, i] . emb[c, j]) * rinv[c, i]) * rinv[c, j]
//             + mud[c, j]
//
// (the int8 dot exact in int32; mud = (emb . mu) * rinv, the dequantized
// y . mu term, computed once by the caller), send j == i and dead slots
// (slot_rows < 0) to NEG_INF, and keep the top r by score, ties to the
// lower slot as lax.top_k keeps them, as global rows (slot_rows[c, j]),
// -1 where the score is <= -1e29.
//
// Layout (cortex_tpu_torch/vector/knn_graph.py passes a chunk of it):
//   emb       [ch, L, d] int8   centered-quantized rows, zero in empty slots
//   rinv      [ch, L]    f32    per-slot dequant factor
//   slot_rows [ch, L]    i32    global row id, -1 for an empty slot
//   mud       [ch, L]    f32    dequantized slot . mu
// Output: out [ch, L, r] i32, each row's list in rank order.
//
// What bounds it: int8 operations. The reference materializes the
// [ch, L, L] int32 and f32 score planes in device memory (8 bytes a
// pair, 13.4 GB at the 1M x 768 layout: 1,024 lists of 1,280 slots);
// the function itself reads the 1.0 GB layout once and writes 168 MB of
// lists, but needs the L (L - 1) / 2 distinct int8 dots of a cluster
// (its self-product is symmetric), L (L - 1) d operations: 1.29 T at
// that layout, 0.65 ms at 1,979 TOP/s, against 0.35 ms of bytes at
// 3.35 TB/s. This kernel does all L^2 dots (twice the bound's).
//
// Design. A work item is (cluster, tile of 128 rows); a persistent grid
// walks the items, one block an SM. A block is two consumer warpgroups
// (64 rows each, the wgmma M) and one producer warp:
//  1. the producer streams the item's column tiles (128 slots) past its
//     rows in K slices of 128 bytes: each ring stage holds the rows'
//     slice and the tile's slice, 128-byte swizzled, loaded by TMA
//     (cp.async.bulk.tensor on two tensor maps of [ch L, d], full and
//     empty mbarriers). For d % 16 != 0 (TMA needs 16-byte strides) the
//     producer warp assembles the same swizzled stage from bytes;
//  2. the consumers multiply each slice with wgmma m64n128k32 s8 x s8 ->
//     s32, both operands K-major from shared memory; a stage is released
//     once every consumer warp's wgmma on it has completed. L2 reads are
//     one pass of both operands for each (row tile, column tile) pair;
//  3. each column tile's epilogue descales in the reference's order
//     (__fmul_rn, __fadd_rn: nvcc would contract a*b + c into an FMA and
//     change the rounding) and masks, and compares every score with its
//     row's running threshold, the r-th (score, slot) kept so far, as
//     64-bit (order-preserving key, ~slot) words: descending words are
//     score desc, slot asc, and -0.0 keys as +0.0, so the two tie as the
//     reference's compare ties them. Scores <= -1e29 never enter a list:
//     they write -1 wherever they would rank. A warp owns 16 rows and a
//     quad (4 threads) one row per half (the accumulator's layout), so
//     the rest is the warp's alone: rows with a candidate stage their
//     scores in shared memory;
//  4. r <= 32: each row's 32 best words live sorted across its quad's
//     registers. Each thread queues its candidates (8 a row, in shared
//     memory, re-tested against the threshold as they are queued); when
//     a queue is full, and after the last column tile, the warp sorts
//     every quad's 32 queued words with a bitonic network across the
//     quad and merges them into the set (the elementwise max with the
//     set reversed, then a bitonic merge), and the threshold becomes the
//     r-th word. r > 32: a warp a row merges its survivors into a sorted
//     list in shared memory or, past what fits, in a device scratch of
//     the wrapper's (128 r words a block): with at most 32 survivors
//     and 32 kept, by ranks from shuffles; else the survivors are
//     bitonic-sorted and each word finds its place by binary search.
//     After the last column tile each row's list goes out once.
// No [rows, L] score plane exists, so L has no shared-memory limit, and
// any r in [1, L - 1] is taken. The selection, not the product, bounds
// the time: PERF.md has the split.
//
// The PyTorch op binding lives in block_knn_op.cpp, so this file never
// includes PyTorch's headers. Compile-time switches for profiling builds
// of this file alone (chip_smoke.py --profile): CORTEX_KNN_PARTS = 1
// stops after the product (no epilogue, no selection, no output), 2
// after the epilogue's threshold tests (nothing staged or selected);
// CORTEX_KNN_WG = 1 makes a block one consumer warpgroup over a tile of
// 64 rows (two blocks an SM).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <mutex>

#include <cuda.h>
#include <cuda_runtime.h>

#include "device_common.cuh"

#ifndef CORTEX_KNN_PARTS
#define CORTEX_KNN_PARTS 0
#endif
#ifndef CORTEX_KNN_WG
#define CORTEX_KNN_WG 2
#endif

namespace {

using namespace cortex_dev;

constexpr int kWG = CORTEX_KNN_WG;          // consumer warpgroups a block
constexpr int kRowsWG = 64;                 // rows a warpgroup (wgmma M)
constexpr int kTileRows = kWG * kRowsWG;
constexpr int kCols = 128;                  // slots a column tile (wgmma N)
constexpr int kSlice = 128;                 // K bytes a stage: one swizzle atom
constexpr int kConsumers = kWG * 128;
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
// Registers a thread after the split (setmaxnreg): the producer
// warpgroup gives its share to the consumers
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = kWG == 1 ? 216 : 232;
constexpr int kMaxStages = 4;
constexpr int kStgStride = kCols + 8;       // staging row stride, floats
constexpr float kDeadScore = -1e29f;        // scores <= this are masked

// Where a row's running top r lives: r <= 32 as a set in the registers
// of the four threads that own the row; else a sorted list in shared
// memory, or, past what fits, in the device scratch.
constexpr int kSetMax = 32;
enum Lists { kListsSet = 0, kListsShared = 1, kListsDevice = 2 };

// Byte offsets of a block's dynamic shared memory (from a 1024-aligned
// base: the swizzled stages need it), for `stages` ring stages and the
// lists' place.
struct Layout {
  int a_bytes, stage_bytes, stg, colb, sortb, theta, nt, bars;
  long long t, total;
};

__host__ __device__ inline Layout knn_layout(int stages, int r, int lists) {
  Layout o;
  constexpr int warps = kConsumers / 32;
  const bool sorted = lists != kListsSet;
  o.a_bytes = kTileRows * kSlice;
  o.stage_bytes = o.a_bytes + kCols * kSlice;
  int at = stages * o.stage_bytes;
  o.stg = at;
  at += warps * 16 * kStgStride * 4;         // a warp's 16 rows of scores
  o.colb = at;
  at += warps * kCols * 8;                   // (rinv, mud) of the tile's slots
  o.sortb = at;                              // a warp's survivors, or
  at += warps * (sorted ? kCols : 32 * 16) * 8;  // its threads' queues
  o.theta = at;
  at += sorted ? kTileRows * 8 : 0;          // each row's threshold word
  o.nt = at;
  at += sorted ? kTileRows * 4 : 0;          // each row's list length
  o.bars = at;
  at += 2 * kMaxStages * 8;
  o.t = at;
  o.total = o.t +
            (lists == kListsShared ? static_cast<long long>(kTileRows) * r * 8
                                   : 0) +
            1024;
  return o;
}

// Sorts like the float (larger key, larger score); -0.0 keys as +0.0.
__device__ __forceinline__ uint32_t order_key(float s) {
  uint32_t u = __float_as_uint(s);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The float a key came from (+0.0 for -0.0).
__device__ __forceinline__ float key_score(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: the box at (x bytes of K, row y) of `map` into `dst`, completing
// its bytes on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(x),
      "r"(y)
      : "memory");
}

// wgmma operand descriptor: K-major rows of 128 bytes, 128-byte swizzle,
// 8-row groups 1024 bytes apart (the TMA box's layout).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (uint64_t{1} << 16) | (uint64_t{1024 >> 4} << 32) |
         (uint64_t{1} << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous product.
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (+)= A (64 x 32 s8, K-major) * B (128 x 32 s8, K-major)^T, s32;
// d is overwritten when `accumulate` is 0.
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t da,
                                                 uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d = A * B for the first K step of a tile: d is only written, so the
// previous tile's accumulators need not stay live across the selection.
__device__ __forceinline__ void wgmma_m64n128k32_first(int (&d)[64],
                                                       uint64_t da,
                                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]),
        "=r"(d[5]), "=r"(d[6]), "=r"(d[7]), "=r"(d[8]), "=r"(d[9]),
        "=r"(d[10]), "=r"(d[11]), "=r"(d[12]), "=r"(d[13]), "=r"(d[14]),
        "=r"(d[15]), "=r"(d[16]), "=r"(d[17]), "=r"(d[18]), "=r"(d[19]),
        "=r"(d[20]), "=r"(d[21]), "=r"(d[22]), "=r"(d[23]), "=r"(d[24]),
        "=r"(d[25]), "=r"(d[26]), "=r"(d[27]), "=r"(d[28]), "=r"(d[29]),
        "=r"(d[30]), "=r"(d[31]), "=r"(d[32]), "=r"(d[33]), "=r"(d[34]),
        "=r"(d[35]), "=r"(d[36]), "=r"(d[37]), "=r"(d[38]), "=r"(d[39]),
        "=r"(d[40]), "=r"(d[41]), "=r"(d[42]), "=r"(d[43]), "=r"(d[44]),
        "=r"(d[45]), "=r"(d[46]), "=r"(d[47]), "=r"(d[48]), "=r"(d[49]),
        "=r"(d[50]), "=r"(d[51]), "=r"(d[52]), "=r"(d[53]), "=r"(d[54]),
        "=r"(d[55]), "=r"(d[56]), "=r"(d[57]), "=r"(d[58]), "=r"(d[59]),
        "=r"(d[60]), "=r"(d[61]), "=r"(d[62]), "=r"(d[63])
      : "l"(da), "l"(db));
}

// Entries of the descending list t[0, n) greater than w.
__device__ __forceinline__ int count_greater(
    const unsigned long long* t, int n, unsigned long long w) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (t[mid] > w) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

constexpr unsigned kFull = 0xffffffffu;

// Compare-exchange in a thread: afterwards a >= b when `desc`, else
// a <= b (a holds the lower position).
__device__ __forceinline__ void cx_pair(unsigned long long& a,
                                        unsigned long long& b, bool desc) {
  const bool swap = desc ? a < b : a > b;
  const unsigned long long x = swap ? b : a;
  b = swap ? a : b;
  a = x;
}

// One bitonic step across a quad whose four threads hold 32 words, word
// p = 8 t4 + i in v[i] of thread t4: positions p and p ^ stride compared,
// the pair in order `desc` where (p & size) == 0, reversed elsewhere.
template <int kSize, int kStride>
__device__ __forceinline__ void quad_step(unsigned long long (&v)[8],
                                          int t4) {
  if constexpr (kStride >= 8) {
    constexpr int lx = kStride / 8;
    const bool lower = (t4 & lx) == 0;
    const bool desc = ((8 * t4) & kSize) == 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const unsigned long long o = __shfl_xor_sync(kFull, v[i], lx);
      const bool keep_max = lower == desc;
      v[i] = keep_max ? (o > v[i] ? o : v[i]) : (o < v[i] ? o : v[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if ((i & kStride) == 0) {
        cx_pair(v[i], v[i + kStride], ((8 * t4 + i) & kSize) == 0);
      }
    }
  }
}

template <int kSize>
__device__ __forceinline__ void quad_merge_steps(unsigned long long (&v)[8],
                                                 int t4) {
  if constexpr (kSize >= 32) quad_step<kSize, 16>(v, t4);
  if constexpr (kSize >= 16) quad_step<kSize, 8>(v, t4);
  if constexpr (kSize >= 8) quad_step<kSize, 4>(v, t4);
  if constexpr (kSize >= 4) quad_step<kSize, 2>(v, t4);
  quad_step<kSize, 1>(v, t4);
}

// The quad's 32 words sorted descending (bitonic sort).
__device__ __forceinline__ void quad_sort(unsigned long long (&v)[8],
                                          int t4) {
  quad_merge_steps<2>(v, t4);
  quad_merge_steps<4>(v, t4);
  quad_merge_steps<8>(v, t4);
  quad_merge_steps<16>(v, t4);
  quad_merge_steps<32>(v, t4);
}

// s (descending) becomes the 32 largest of s and c (both descending): the
// elementwise max of s and c reversed holds them as a bitonic sequence,
// which a bitonic merge sorts.
__device__ __forceinline__ void quad_merge(unsigned long long (&s)[8],
                                           const unsigned long long (&c)[8],
                                           int t4) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const unsigned long long o = __shfl_xor_sync(kFull, c[7 - i], 3);
    s[i] = o > s[i] ? o : s[i];
  }
  quad_merge_steps<64>(s, t4);
}

// A thread's share of one row's running top r (kSet): the row's 32 best
// words so far, sorted descending across the quad (word 8 t4 + i in
// s[i]; 0 where there is none yet), its threshold word max(theta0, the
// r-th), and how many words this thread has queued for it.
struct RowSet {
  unsigned long long s[8];
  unsigned long long th;
  int nq;

  __device__ __forceinline__ void clear(unsigned long long theta0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = 0ull;
    th = theta0;
    nq = 0;
  }
};

// One round for every quad of the warp: each thread's queued words q[0,
// nq) (kConsumers words apart) sorted across the quad and merged into
// the set; the queue emptied; then the threshold becomes max(theta0, the
// set's r-th word).
__device__ __forceinline__ void merge_queue(RowSet& rs,
                                            const unsigned long long* q,
                                            int r, unsigned long long theta0,
                                            int lane) {
  const int t4 = lane & 3;
  unsigned long long c[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) c[i] = i < rs.nq ? q[i * kConsumers] : 0ull;
  rs.nq = 0;
  quad_sort(c, t4);
  quad_merge(rs.s, c, t4);
  // the r-th word: thread (r - 1) / 8 of the quad, entry (r - 1) % 8
  unsigned long long v = 0ull;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (i == ((r - 1) & 7)) v = rs.s[i];
  }
  v = __shfl_sync(kFull, v, (lane & ~3) | ((r - 1) >> 3));
  rs.th = v > theta0 ? v : theta0;
}

// A column tile's candidates for one row (kSet): this thread's passing
// slots `m` (bit 2 j8 + e: column 8 j8 + 2 t4 + e of the staged row
// srow) queued, each re-tested against the threshold; whenever a thread
// of the warp still has candidates and a full queue, a merge round.
__device__ __forceinline__ void select_row(RowSet& rs, unsigned m,
                                           const float* srow,
                                           unsigned long long* qrow, int j0,
                                           int r, unsigned long long theta0,
                                           int lane) {
  const int t4 = lane & 3;
  while (true) {
    while (m != 0u && rs.nq < 8) {
      const int bit = __ffs(m) - 1;
      m &= m - 1u;
      const int cl = 8 * (bit >> 1) + 2 * t4 + (bit & 1);
      const unsigned long long w =
          (static_cast<unsigned long long>(order_key(srow[cl])) << 32) |
          static_cast<uint32_t>(~(j0 + cl));
      if (w > rs.th) qrow[rs.nq++ * kConsumers] = w;
    }
    if (!__any_sync(kFull, m != 0u)) break;
    merge_queue(rs, qrow, r, theta0, lane);
  }
}

// A row's list out (kSet): the queues merged, the sorted set's first r
// words as global rows, -1 where no real word is.
__device__ __forceinline__ void out_row(RowSet& rs, unsigned long long* qrow,
                                        bool in, int32_t* o,
                                        const int32_t* slot_rows, int r,
                                        unsigned long long theta0,
                                        int lane) {
  if (__any_sync(kFull, rs.nq > 0)) merge_queue(rs, qrow, r, theta0, lane);
  if (!in) return;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int pos = 8 * (lane & 3) + k;
    const unsigned long long v = rs.s[k];
    if (pos < r) {
      o[pos] = v > theta0 ? __ldg(slot_rows + static_cast<int>(
                                                  ~static_cast<uint32_t>(v)))
                          : -1;
    }
  }
}

struct KnnArgs {
  const int8_t* emb;
  const float* rinv;
  const int32_t* slot_rows;
  const float* mud;
  int32_t* out;
  unsigned long long* tg;   // running lists in device memory (null: shared)
  long long total_rows;     // ch * L
  int l_count, d, r, n_slices, n_ctiles, n_rtiles, n_items, stages, lists;
};

// Merges the warp's sorted survivor words sb[0, s_n) (s_n <= kCols) into
// the descending list t[0, n) of capacity r; returns the new length.
// Every word is distinct (slots differ), so ranks are exact.
__device__ int merge_general(unsigned long long* t, int n, int r,
                             unsigned long long* sb, int s_n, int lane) {
  int p = 1;
  while (p < s_n) p <<= 1;
  for (int e = s_n + lane; e < p; e += 32) sb[e] = 0ull;
  __syncwarp();
  // bitonic sort, descending, of the warp's p words (0 pads sort last)
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int e = lane; e < p; e += 32) {
        const int o = e ^ stride;
        if (o > e) {
          const unsigned long long x = sb[e], y = sb[o];
          if ((e & size) == 0 ? x < y : x > y) {
            sb[e] = y;
            sb[o] = x;
          }
        }
      }
      __syncwarp();
    }
  }
  // each survivor's place: its rank among the survivors plus the list's
  // entries above it
  int pos[kCols / 32];
#pragma unroll
  for (int m = 0; m < kCols / 32; ++m) {
    const int k = lane + 32 * m;
    pos[m] = k < s_n ? k + count_greater(t, n, sb[k]) : r;
  }
  const int p0 = __shfl_sync(0xffffffffu, pos[0], 0);   // survivor 0's
  __syncwarp();
  // the list's entries from p0 on move down by the survivors above them;
  // a top chunk first, each read whole before any of it is written
  for (int hi = n; hi > p0; hi -= 32) {
    const int i = hi - 1 - lane;
    const bool valid = i >= p0;
    const unsigned long long w = valid ? t[i] : 0ull;
    const int dst = valid ? i + count_greater(sb, s_n, w) : r;
    __syncwarp();
    if (dst < r) t[dst] = w;
    __syncwarp();
  }
#pragma unroll
  for (int m = 0; m < kCols / 32; ++m) {
    if (pos[m] < r) t[pos[m]] = sb[lane + 32 * m];
  }
  __syncwarp();
  return min(r, n + s_n);
}

// The same merge for n <= 32 and s_n <= 32 survivors (unsorted), a word
// a lane: both ranks by shuffles.
__device__ __forceinline__ int merge_small(unsigned long long* t, int n,
                                           int r,
                                           const unsigned long long* sb,
                                           int s_n, int lane) {
  const unsigned long long xs = lane < s_n ? sb[lane] : 0ull;
  const unsigned long long xt = lane < n ? t[lane] : 0ull;
  int above_s = 0, above_t = 0;     // survivors above xs, above xt
  for (int k = 0; k < s_n; ++k) {
    const unsigned long long y = __shfl_sync(0xffffffffu, xs, k);
    above_s += y > xs;
    above_t += y > xt;
  }
  int in_t = 0;                     // list entries above xs
#pragma unroll
  for (int step = 32; step >= 1; step >>= 1) {
    const int probe = in_t + step - 1;
    const unsigned long long y = __shfl_sync(0xffffffffu, xt, probe & 31);
    if (probe < n && y > xs) in_t += step;
  }
  __syncwarp();
  if (lane < n && lane + above_t < r) t[lane + above_t] = xt;
  if (lane < s_n && above_s + in_t < r) t[above_s + in_t] = xs;
  __syncwarp();
  return min(r, n + s_n);
}

template <bool kAligned, bool kSet>
__global__ void __launch_bounds__(kThreads, kWG == 1 ? 2 : 1)
    block_knn_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b,
                     const KnnArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const Layout lay = knn_layout(a.stages, a.r, a.lists);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + lay.bars);
  uint64_t* empty = full + kMaxStages;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int L = a.l_count;
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full + s, kAligned ? 1 : 32);
      mbar_init(empty + s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- the producer warpgroup: one warp streams every item's column
    // tiles, slice by slice; the others only give their registers away
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid >= kConsumers + 32) return;
    if (kAligned && lane != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int item = blockIdx.x; item < a.n_items; item += gridDim.x) {
      const int c = item / a.n_rtiles;
      const long long row_a = static_cast<long long>(c) * L +
                              (item - c * a.n_rtiles) * kTileRows;
      for (int ct = 0; ct < a.n_ctiles; ++ct) {
        const long long row_b = static_cast<long long>(c) * L + ct * kCols;
        for (int s = 0; s < a.n_slices; ++s) {
          mbar_wait(empty + stage, phase ^ 1);
          unsigned char* st = sm + stage * lay.stage_bytes;
          if (kAligned) {
            mbar_expect_tx(full + stage, lay.stage_bytes);
            tma_load_2d(st, &map_a, full + stage, s * kSlice,
                        static_cast<int>(row_a));
            tma_load_2d(st + lay.a_bytes, &map_b, full + stage, s * kSlice,
                        static_cast<int>(row_b));
          } else {
            // the stage's rows (tile rows, then the column tile's slots)
            // from bytes, zero past d and past the layout, swizzled as
            // the TMA box would be
            for (int u = lane; u < (kTileRows + kCols) * 8; u += 32) {
              const int rr = u >> 3;
              const int cc = u & 7;
              const long long g =
                  rr < kTileRows ? row_a + rr : row_b + (rr - kTileRows);
              const int k0 = s * kSlice + cc * 16;
              uint32_t w[4] = {0u, 0u, 0u, 0u};
              if (g < a.total_rows) {
                const int8_t* rp = a.emb + g * a.d + k0;
                for (int x = 0; x < 16 && k0 + x < a.d; ++x) {
                  w[x >> 2] |=
                      static_cast<uint32_t>(static_cast<uint8_t>(rp[x]))
                      << (8 * (x & 3));
                }
              }
              *reinterpret_cast<uint4*>(st + rr * kSlice +
                                        ((cc ^ (rr & 7)) << 4)) =
                  make_uint4(w[0], w[1], w[2], w[3]);
            }
            // generic-proxy writes, read by wgmma through the async proxy
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            mbar_arrive(full + stage);
          }
          if (++stage == a.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- the consumers: warpgroup g; each warp owns tile rows rb..rb + 15
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int g = warp >> 2;
  const int rb = g * kRowsWG + (warp & 3) * 16;
  const int t4 = lane & 3;
  const int q0 = lane >> 2;              // this thread's rows rb + q0 (+ 8)
  const unsigned lt_mask = (1u << lane) - 1u;
  float* stg = reinterpret_cast<float*>(sm + lay.stg) + warp * 16 * kStgStride;
  float2* colb = reinterpret_cast<float2*>(sm + lay.colb) + warp * kCols;
  unsigned long long* sb =
      reinterpret_cast<unsigned long long*>(sm + lay.sortb) + warp * kCols;
  unsigned long long* theta =
      reinterpret_cast<unsigned long long*>(sm + lay.theta) + rb;
  int* ntv = reinterpret_cast<int*>(sm + lay.nt) + rb;
  unsigned long long* tl =
      a.lists == kListsShared
          ? reinterpret_cast<unsigned long long*>(sm + lay.t) +
                static_cast<long long>(rb) * a.r
          : a.tg + (static_cast<long long>(blockIdx.x) * kTileRows + rb) * a.r;
  const unsigned long long theta0 =
      (static_cast<unsigned long long>(order_key(kDeadScore)) << 32) |
      0xffffffffull;
  int stage = 0;
  uint32_t phase = 0;
  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  // kSet: this thread's share of its two rows' sets (set0: row rb + q0,
  // set1: 8 rows on) and their queues (8 words a row in shared memory,
  // word k of row h at (8 h + k) kConsumers + tid: free of bank
  // conflicts). Two named structs, not an array: every index stays a
  // compile-time one, so the sets stay in registers.
  RowSet set0, set1;
  unsigned long long* queue =
      reinterpret_cast<unsigned long long*>(sm + lay.sortb) + tid;
#if CORTEX_KNN_PARTS == 1
  int sink = 0;
#endif

  for (int item = blockIdx.x; item < a.n_items; item += gridDim.x) {
    const int c = item / a.n_rtiles;
    const int i0 = (item - c * a.n_rtiles) * kTileRows;
    const long long cbase = static_cast<long long>(c) * L;
    if constexpr (kSet) {
      set0.clear(theta0);
      set1.clear(theta0);
    } else if (lane < 16) {
      theta[lane] = theta0;
      ntv[lane] = 0;
    }
    int iq[2];
    float ri[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      iq[h] = i0 + rb + q0 + 8 * h;
      ri[h] = iq[h] < L ? __ldg(a.rinv + cbase + iq[h]) : 0.0f;
    }
    __syncwarp();

    // the column planes of a tile, loaded a tile ahead: slot k of this
    // thread is j0 + lane + 32 k
    int pr[kCols / 32];
    float pi[kCols / 32], pm[kCols / 32];
    auto load_planes = [&](int j0) {
#pragma unroll
      for (int k = 0; k < kCols / 32; ++k) {
        const int j = j0 + lane + 32 * k;
        const bool in = j < L;
        pr[k] = in ? __ldg(a.slot_rows + cbase + j) : -1;
        pi[k] = in ? __ldg(a.rinv + cbase + j) : 0.0f;
        pm[k] = in ? __ldg(a.mud + cbase + j) : 0.0f;
      }
    };
    load_planes(0);

    for (int ct = 0; ct < a.n_ctiles; ++ct) {
      const int j0 = ct * kCols;
      // the tile's slots: liveness bits, and (rinv, mud) for the epilogue
      uint32_t live[kCols / 32];
      __syncwarp();
#pragma unroll
      for (int k = 0; k < kCols / 32; ++k) {
        live[k] = __ballot_sync(kFull, pr[k] >= 0);
        colb[lane + 32 * k] = make_float2(pi[k], pm[k]);
      }
      if (ct + 1 < a.n_ctiles) load_planes(j0 + kCols);

      // ---- the product over d, a 128-byte slice a stage; 32 bytes of K
      // a wgmma (the descriptors' addresses move 2 x 16 bytes); one
      // group in flight while the next slice is awaited
      mbar_wait(full + stage, phase);
      {
        const unsigned char* st = sm + stage * lay.stage_bytes;
        const uint64_t da = sw128_desc(st + g * kRowsWG * kSlice);
        const uint64_t db = sw128_desc(st + lay.a_bytes);
        wgmma_fence();
        wgmma_m64n128k32_first(acc, da, db);
#pragma unroll
        for (int kk = 1; kk < kSlice / 32; ++kk) {
          wgmma_m64n128k32(acc, da + 2 * kk, db + 2 * kk, 1);
        }
        wgmma_commit();
      }
      int prev = stage;
      if (++stage == a.stages) {
        stage = 0;
        phase ^= 1;
      }
      for (int s = 1; s < a.n_slices; ++s) {
        mbar_wait(full + stage, phase);
        const unsigned char* st = sm + stage * lay.stage_bytes;
        const uint64_t da = sw128_desc(st + g * kRowsWG * kSlice);
        const uint64_t db = sw128_desc(st + lay.a_bytes);
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSlice / 32; ++kk) {
          wgmma_m64n128k32(acc, da + 2 * kk, db + 2 * kk, 1);
        }
        wgmma_commit();
        wgmma_wait<1>();
        fence_acc(acc);
        if (lane == 0) mbar_arrive(empty + prev);
        prev = stage;
        if (++stage == a.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(empty + prev);
#if CORTEX_KNN_PARTS == 1
#pragma unroll
      for (int i = 0; i < 64; ++i) sink ^= acc[i];
      continue;
#endif
      __syncwarp();

      // ---- epilogue: descale, mask, test against the rows' thresholds
      float ths[2];
      int thc[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned long long w =
            kSet ? (h == 0 ? set0.th : set1.th) : theta[q0 + 8 * h];
        ths[h] = key_score(static_cast<uint32_t>(w >> 32));
        thc[h] = static_cast<int>(~static_cast<uint32_t>(w));
      }
      bool flag[2] = {false, false};
      unsigned cm[2] = {0u, 0u};   // kSet: this thread's passing scores
#pragma unroll
      for (int j8 = 0; j8 < kCols / 8; ++j8) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cl = 8 * j8 + 2 * t4 + e;
          const int j = j0 + cl;
          const float2 cb = colb[cl];
          const bool okc = (live[j8 >> 2] >> (8 * (j8 & 3) + 2 * t4 + e)) & 1u;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            int& v = acc[4 * j8 + 2 * h + e];
            float s = -INFINITY;
            if (okc && j != iq[h]) {
              s = __fadd_rn(
                  __fmul_rn(__fmul_rn(__int2float_rn(v), ri[h]), cb.x), cb.y);
            }
            const bool pass = s > ths[h] || (s == ths[h] && j < thc[h]);
            flag[h] = flag[h] || pass;
            cm[h] |= static_cast<unsigned>(pass) << (2 * j8 + e);
            v = __float_as_int(s);
          }
        }
      }
      unsigned rm = 0;     // the warp's rows with a survivor
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (iq[h] >= L) cm[h] = 0u;
        int f = flag[h] && iq[h] < L;
        f |= __shfl_xor_sync(0xffffffffu, f, 1);
        f |= __shfl_xor_sync(0xffffffffu, f, 2);
        flag[h] = f != 0;
        const unsigned b = __ballot_sync(0xffffffffu, flag[h]);
#pragma unroll
        for (int k = 0; k < 8; ++k) rm |= ((b >> (4 * k)) & 1u) << (k + 8 * h);
      }
      if (rm != 0 && CORTEX_KNN_PARTS != 2) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (flag[h]) {
            float* srow = stg + (q0 + 8 * h) * kStgStride + 2 * t4;
#pragma unroll
            for (int j8 = 0; j8 < kCols / 8; ++j8) {
              *reinterpret_cast<float2*>(srow + 8 * j8) =
                  make_float2(__int_as_float(acc[4 * j8 + 2 * h]),
                              __int_as_float(acc[4 * j8 + 2 * h + 1]));
            }
          }
        }
        __syncwarp();
      }
      if (rm == 0 || CORTEX_KNN_PARTS == 2) continue;

      if constexpr (kSet) {
        // ---- selection into the sets: each thread queues its row's
        // candidates in shared memory (at most 8, each re-tested against
        // the threshold as it is queued); when a thread's queue is full,
        // and after the last column tile, the warp merges every quad's
        // 32 queued words into its row's sorted set
        select_row(set0, cm[0], stg + q0 * kStgStride, queue, j0, a.r,
                   theta0, lane);
        select_row(set1, cm[1], stg + (q0 + 8) * kStgStride,
                   queue + 8 * kConsumers, j0, a.r, theta0, lane);
        __syncwarp();
      } else {
        // ---- selection: a row at a time, the warp's flagged rows
        while (rm != 0) {
          const int q = __ffs(rm) - 1;
          rm &= rm - 1;
          const unsigned long long thr = theta[q];
          const float* srow = stg + q * kStgStride;
          int s_n = 0;
#pragma unroll
          for (int m = 0; m < kCols / 32; ++m) {
            const int cl = lane + 32 * m;
            const unsigned long long w =
                (static_cast<unsigned long long>(order_key(srow[cl])) << 32) |
                static_cast<uint32_t>(~(j0 + cl));
            const bool sv = w > thr;
            const unsigned b = __ballot_sync(0xffffffffu, sv);
            if (sv) sb[s_n + __popc(b & lt_mask)] = w;
            s_n += __popc(b);
          }
          __syncwarp();
          unsigned long long* trow = tl + static_cast<long long>(q) * a.r;
          int n = ntv[q];
          if (s_n > 0) {
            n = n <= 32 && s_n <= 32
                    ? merge_small(trow, n, a.r, sb, s_n, lane)
                    : merge_general(trow, n, a.r, sb, s_n, lane);
          }
          if (lane == 0) {
            ntv[q] = n;
            if (n == a.r) theta[q] = trow[a.r - 1];
          }
          __syncwarp();
        }
      }
    }

#if CORTEX_KNN_PARTS != 1
    if constexpr (kSet) {
      // ---- out: a sorted set's first r words as global rows, -1 where
      // no real word is
      out_row(set0, queue, iq[0] < L, a.out + (cbase + iq[0]) * a.r,
              a.slot_rows + cbase, a.r, theta0, lane);
      out_row(set1, queue + 8 * kConsumers, iq[1] < L,
              a.out + (cbase + iq[1]) * a.r, a.slot_rows + cbase, a.r, theta0,
              lane);
    } else {
      // ---- out: each row's list as global rows, -1 past its length
      for (int q = 0; q < 16 && i0 + rb + q < L; ++q) {
        const unsigned long long* trow =
            tl + static_cast<long long>(q) * a.r;
        const int n = ntv[q];
        int32_t* o = a.out + (cbase + i0 + rb + q) * a.r;
        for (int e = lane; e < a.r; e += 32) {
          o[e] = e < n ? __ldg(a.slot_rows + cbase +
                               static_cast<int>(
                                   ~static_cast<uint32_t>(trow[e])))
                       : -1;
        }
      }
      __syncwarp();
    }
#endif
  }
#if CORTEX_KNN_PARTS == 1
  if (sink == 0x5a5a5a5a) a.out[blockIdx.x] = sink;   // keeps the product
#endif
}

using KnnKernel = void (*)(CUtensorMap, CUtensorMap, KnnArgs);

KnnKernel knn_kernel(bool aligned, bool set) {
  if (set) {
    return aligned ? block_knn_kernel<true, true>
                   : block_knn_kernel<false, true>;
  }
  return aligned ? block_knn_kernel<true, false>
                 : block_knn_kernel<false, false>;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda).
cudaError_t encode_tiled(EncodeTiled* out) {
  static std::once_flag once;
  static EncodeTiled fn = nullptr;
  static cudaError_t err = cudaSuccess;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                           12000, cudaEnableDefault, &q);
#else
    err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                  cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q != cudaDriverEntryPointSuccess) {
      err = cudaErrorSymbolNotFound;
    }
    fn = reinterpret_cast<EncodeTiled>(p);
  });
  *out = fn;
  return err;
}

// [rows, d] int8 as a 2-D tensor map: boxes of 128 bytes x box_rows rows,
// 128-byte swizzled, zero-filled past either edge.
cudaError_t make_map(CUtensorMap* map, const void* emb, long long rows, int d,
                     int box_rows) {
  EncodeTiled fn = nullptr;
  const cudaError_t err = encode_tiled(&fn);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d)};
  const cuuint32_t box[2] = {kSlice, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(emb), dims,
         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

struct KnnPlan {
  int stages, lists, grid;
  size_t smem;
  long long scratch_bytes;
};

// Ring depth, where the running lists live, the dynamic shared memory and
// the persistent grid of a launch on the current device. Two consumer
// warpgroups a block take the card's opt-in shared memory, one a block
// half an SM's (two blocks an SM). r <= 32 keeps sets in registers; else
// the lists go to shared memory when they fit beside a ring of at least
// two stages, or to the device scratch (kTileRows r words a block).
cudaError_t plan_knn(int ch, int l_count, int r, bool aligned, KnnPlan* p) {
  DeviceLimits lim;
  cudaError_t err = device_limits(&lim);
  if (err != cudaSuccess) return err;
  int per_sm_smem = 0, reserved = 0;
  err = cudaDeviceGetAttribute(&per_sm_smem,
                               cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                               lim.dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &reserved, cudaDevAttrReservedSharedMemoryPerBlock, lim.dev);
  }
  if (err != cudaSuccess) return err;
  const long long budget =
      kWG == 1 ? std::min<long long>(lim.smem_optin,
                                     per_sm_smem / 2 - reserved)
               : lim.smem_optin;
  p->stages = 0;
  const int first = r <= kSetMax ? kListsSet : kListsShared;
  const int last = r <= kSetMax ? kListsSet : kListsDevice;
  for (int lists = first; lists <= last && p->stages == 0; ++lists) {
    for (int stages = kMaxStages; stages >= 2; --stages) {
      if (knn_layout(stages, r, lists).total <= budget) {
        p->stages = stages;
        p->lists = lists;
        break;
      }
    }
  }
  if (p->stages == 0) return cudaErrorInvalidValue;
  p->smem = static_cast<size_t>(knn_layout(p->stages, r, p->lists).total);
  int per_sm = 0;
  err = fit_kernel(reinterpret_cast<const void*>(
                       knn_kernel(aligned, p->lists == kListsSet)),
                   kThreads, p->smem, &lim, &per_sm);
  if (err != cudaSuccess) return err;
  const long long items = static_cast<long long>(ch) *
                          ((l_count + kTileRows - 1) / kTileRows);
  p->grid = static_cast<int>(
      std::min<long long>(items, static_cast<long long>(lim.sm_count) *
                                     std::max(per_sm, 1)));
  p->scratch_bytes = p->lists != kListsDevice
                         ? 0
                         : static_cast<long long>(p->grid) * kTileRows * r * 8;
  return cudaSuccess;
}

}  // namespace

// Bytes of device scratch a launch at (ch, L, r) needs for its running
// lists (0 when they live in shared memory), or -(cudaError_t) on a
// runtime error.
extern "C" long long cortex_block_knn_scratch(int ch, int l_count, int d,
                                              int r, int aligned) {
  (void)d;
  if (ch == 0 || l_count == 0 || r == 0) return 0;
  KnnPlan p;
  const cudaError_t err = plan_knn(ch, l_count, r, aligned != 0, &p);
  return err != cudaSuccess ? -static_cast<long long>(err) : p.scratch_bytes;
}

// Enqueue N1 on `stream`; returns the cudaError_t of the launch (0 =
// success). The caller has checked shapes, types and devices, and hands
// over cortex_block_knn_scratch's bytes in `scratch`; `aligned` = d % 16
// == 0 with a 16-byte aligned emb (the TMA route).
extern "C" int cortex_block_knn_launch(const void* emb, const void* rinv,
                                       const void* slot_rows,
                                       const void* mud, void* out,
                                       void* scratch, int ch, int l_count,
                                       int d, int r, int aligned,
                                       void* stream) {
  if (ch == 0 || l_count == 0 || r == 0) return 0;
  KnnPlan p;
  cudaError_t err = plan_knn(ch, l_count, r, aligned != 0, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.lists == kListsDevice && scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  KnnArgs a;
  a.emb = static_cast<const int8_t*>(emb);
  a.rinv = static_cast<const float*>(rinv);
  a.slot_rows = static_cast<const int32_t*>(slot_rows);
  a.mud = static_cast<const float*>(mud);
  a.out = static_cast<int32_t*>(out);
  a.tg = static_cast<unsigned long long*>(scratch);
  a.total_rows = static_cast<long long>(ch) * l_count;
  a.l_count = l_count;
  a.d = d;
  a.r = r;
  a.n_slices = (d + kSlice - 1) / kSlice;
  a.n_ctiles = (l_count + kCols - 1) / kCols;
  a.n_rtiles = (l_count + kTileRows - 1) / kTileRows;
  a.n_items = ch * a.n_rtiles;
  a.stages = p.stages;
  a.lists = p.lists;
  CUtensorMap map_a, map_b;
  std::fill(reinterpret_cast<char*>(&map_a),
            reinterpret_cast<char*>(&map_a) + sizeof(map_a), 0);
  std::fill(reinterpret_cast<char*>(&map_b),
            reinterpret_cast<char*>(&map_b) + sizeof(map_b), 0);
  if (aligned) {
    err = make_map(&map_a, emb, a.total_rows, d, kTileRows);
    if (err == cudaSuccess) err = make_map(&map_b, emb, a.total_rows, d, kCols);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const KnnKernel k = knn_kernel(aligned != 0, p.lists == kListsSet);
  k<<<p.grid, kThreads, p.smem, static_cast<cudaStream_t>(stream)>>>(
      map_a, map_b, a);
  return static_cast<int>(cudaGetLastError());
}
