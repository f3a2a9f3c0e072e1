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
// So no score plane leaves the SM:
//  1. a block takes kRows rows of one cluster (8, 16, 32 or 64: the most
//     whose strip fits in shared memory), loads them once into shared
//     memory, and streams the cluster's slots past them in tiles of 64
//     slots through a kStages-deep cp.async ring of 128-byte K slices
//     (XOR-swizzled as in ivf_gather.cu, so ldmatrix reads are free of
//     bank conflicts; other d are assembled from bytes, zero-padded);
//  2. mma.sync m16n8k32 s8 x s8 -> s32 puts 16 slots a warp on M and the
//     block's rows on N (4 warps on the tile's slots, 2 on its rows; at
//     kRows 8, one fragment of rows, the 2 split each slice's K, and the
//     epilogue adds the halves' int32 sums, exactly);
//  3. each tile's epilogue descales in the reference's order (__fmul_rn,
//     __fadd_rn: nvcc would contract a*b + c into an FMA and change the
//     rounding), masks, and writes the scores into the block's
//     [kRows, L] strip in shared memory (80 KB at kRows 16, L 1,280);
//  4. then a warp a row selects the row's exact top r from the strip: a
//     radix select over order-preserving 32-bit keys (4 passes of 8 bits,
//     a 256-bin histogram a warp) finds the r-th largest key T; the
//     elements above T and the lowest-slot elements equal to T are
//     compacted as 64-bit (key, ~slot) words, which a bitonic sort in the
//     warp's shared memory puts in (score desc, slot asc) order.
//     -0.0 keys as +0.0, so the two tie as the reference's compare ties
//     them. Every output is written once; nothing else goes out.
// The cluster is re-read from L2 for every kRows rows (L / kRows times,
// 40 GB of L2 reads at 1M with kRows 32), and with one block an SM the
// selection does not overlap the product: on an H100 the two take about
// half each of 2.7 ms a chunk of 64 lists (CORTEX_KNN_PARTS below), far
// from the 0.041 ms bound. Limits: the strip, the row tile and the ring, or
// the histograms and the sort buffers (r rounded up to a power of two,
// 8 bytes an entry, a warp), must fit the card's opt-in shared memory
// (cortex_block_knn_rows returns 0 when no kRows fits; the binding
// raises ValueError). On an H100 (227 KB a block), at d 768 and r 32:
// L <= 6,224 (kRows 32 up to L 1,424, 16 up to 3,040, then 8); at
// r 1,024: L <= 4,880. The auto layout has L 1,280 at 1M rows and
// 4,096 at 10M; past about 40M rows (nlist at its cap of 8,192) L
// outgrows the strip.
//
// The PyTorch op binding lives in block_knn_op.cpp, so this file never
// includes PyTorch's headers. CORTEX_KNN_PARTS cuts the kernel for
// profiling builds of this file alone (chip_smoke.py --profile): 1 stops
// after the product (the strip written, nothing selected), 2 skips the
// product (the selection over whatever the strip holds).

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

#include "device_common.cuh"

#ifndef CORTEX_KNN_PARTS
#define CORTEX_KNN_PARTS 0
#endif

namespace {

using namespace cortex_dev;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlotWarps = 4;               // warps on a tile's slots
constexpr int kTileSlots = 16 * kSlotWarps;  // slots a ring stage
constexpr int kSlice = 128;                 // bytes of K a ring stage
constexpr int kStages = 3;
constexpr int kBins = 256;
constexpr float kNegInf = -1e30f;
constexpr float kDeadScore = -1e29f;        // scores <= this are masked

// Strip row stride in floats: L rounded up to 16, plus 4, so the epilogue's
// four row groups of a warp (rows 2 apart) land on disjoint banks.
__host__ __device__ inline int strip_stride(int l_count) {
  return (l_count + 15) / 16 * 16 + 4;
}

__host__ __device__ inline int padded_d(int d) {
  return (d + kSlice - 1) / kSlice * kSlice;
}

// entries of a warp's sort buffer: r rounded up to a power of two
__host__ __device__ inline int sort_len(int r) {
  int p = 1;
  while (p < r) p <<= 1;
  return p;
}

// Dynamic shared memory of a launch with kRows rows a block: the strip,
// then a region used first for the row tile and the ring, then for each
// warp's histogram and compacted list.
size_t smem_bytes(int rows, int l_count, int d, int r) {
  const size_t strip = static_cast<size_t>(rows) * strip_stride(l_count) * 4;
  const size_t product = static_cast<size_t>(rows) * padded_d(d) +
                         static_cast<size_t>(kStages) * kTileSlots * kSlice;
  const size_t select = static_cast<size_t>(kWarps) *
                        (kBins * 4 + static_cast<size_t>(sort_len(r)) * 8);
  return (strip + 127) / 128 * 128 + std::max(product, select);
}

// Sorts like the float (larger key, larger score); -0.0 keys as +0.0.
__device__ __forceinline__ uint32_t order_key(float s) {
  uint32_t u = __float_as_uint(s);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

struct KnnArgs {
  const int8_t* emb;
  const float* rinv;
  const int32_t* slot_rows;
  const float* mud;
  int32_t* out;
  int l_count, d, r, n_slices, n_tiles, row_tiles;
};

template <int kRows, bool kAligned>
__global__ void __launch_bounds__(kThreads, 1)
    block_knn_kernel(const KnnArgs a) {
  // row fragments (of 8) a warp; at kRows 8 the one fragment, each
  // half of the warps on half of a slice's K
  constexpr int kFpw = kRows >= 16 ? kRows / 16 : 1;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float rri[kRows];          // rinv of the block's rows
  // kRows 8: the K half of warps 4-7, [slot warp][e][lane]
  __shared__ int xacc[kRows == 8 ? kSlotWarps * 4 * 32 : 1];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int sw = warp % kSlotWarps;     // 16-slot group of the tile
  const int g = warp / kSlotWarps;      // row half
  const int c = blockIdx.x / a.row_tiles;
  const int i0 = (blockIdx.x - c * a.row_tiles) * kRows;
  const int L = a.l_count;
  const int dpad = a.n_slices * kSlice;
  const int sstride = strip_stride(L);
  const int64_t cbase = static_cast<int64_t>(c) * L;
  const int8_t* emb = a.emb + cbase * a.d;
  float* strip = reinterpret_cast<float*>(smem);
  unsigned char* region =
      smem + (static_cast<size_t>(kRows) * sstride * 4 + 127) / 128 * 128;
  unsigned char* rsm = region;                        // [kRows][dpad]
  unsigned char* ring = region + kRows * dpad;  // [kStages][64][kSlice]
  const int steps = CORTEX_KNN_PARTS == 2 ? 0 : a.n_tiles * a.n_slices;

  // one pipeline step: slice `step % n_slices` of slot tile
  // `step / n_slices` into ring stage `step % kStages`
  auto load_step = [&](int step) {
    const int tile = step / a.n_slices;
    const int slice = step - tile * a.n_slices;
    unsigned char* st = ring + (step % kStages) * (kTileSlots * kSlice);
#pragma unroll
    for (int u8 = 0; u8 < (kTileSlots * 8) / kThreads; ++u8) {
      const int u = tid + u8 * kThreads;
      const int rr = u >> 3;
      const int cc = u & 7;
      const int slot = tile * kTileSlots + rr;
      const bool in = slot < L;
      const int k0 = slice * kSlice + cc * 16;
      unsigned char* dst = st + swz(rr, cc, kSlice);
      if (kAligned) {
        const bool ok = in && k0 < a.d;
        cp_async16(dst, ok ? emb + static_cast<int64_t>(slot) * a.d + k0 : emb,
                   ok ? 16 : 0);
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        if (in) {
          const int8_t* rp = emb + static_cast<int64_t>(slot) * a.d + k0;
          for (int x = 0; x < 16 && k0 + x < a.d; ++x) {
            w[x >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(rp[x]))
                         << (8 * (x & 3));
          }
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_step(s);
    cp_async_commit();
  }
  // the block's rows, zero past L and past d, and their rinv
  if (tid < kRows) {
    rri[tid] = i0 + tid < L ? __ldg(a.rinv + cbase + i0 + tid) : 0.0f;
  }
  {
    const int qchunks = dpad / 16;
    for (int u = tid; u < kRows * qchunks; u += kThreads) {
      const int q = u / qchunks;
      const int cc = u - q * qchunks;
      const int k0 = cc * 16;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (i0 + q < L) {
        const int8_t* rp = emb + static_cast<int64_t>(i0 + q) * a.d + k0;
        if (kAligned) {
          if (k0 < a.d) {
            const int4 x = __ldg(reinterpret_cast<const int4*>(rp));
            w[0] = x.x;
            w[1] = x.y;
            w[2] = x.z;
            w[3] = x.w;
          }
        } else {
          for (int x = 0; x < 16 && k0 + x < a.d; ++x) {
            w[x >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(rp[x]))
                         << (8 * (x & 3));
          }
        }
      }
      *reinterpret_cast<uint4*>(rsm + swz(q, cc, dpad)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }

  int acc[kFpw][4];
#pragma unroll
  for (int f = 0; f < kFpw; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[f][e] = 0;
  // this thread's slots of the tile, 16 sw + lane / 4 (+ 8), and their
  // planes, loaded at the tile's first slice and used in its epilogue
  int ls[2];
  bool live[2];
  float ri[2], md[2];
  const int mi = lane >> 3;
  const int mr = lane & 7;

  for (int step = 0; step < steps; ++step) {
    const int tile = step / a.n_slices;
    const int slice = step - tile * a.n_slices;
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (step + kStages - 1 < steps) load_step(step + kStages - 1);
    cp_async_commit();
    if (slice == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ls[h] = tile * kTileSlots + 16 * sw + (lane >> 2) + 8 * h;
        const bool in = ls[h] < L;
        live[h] = in && __ldg(a.slot_rows + cbase + ls[h]) >= 0;
        ri[h] = in ? __ldg(a.rinv + cbase + ls[h]) : 0.0f;
        md[h] = in ? __ldg(a.mud + cbase + ls[h]) : 0.0f;
      }
    }
    // the product: A = this warp's 16 slots, B = the block's rows
    const unsigned char* st = ring + (step % kStages) * (kTileSlots * kSlice);
    if constexpr (kRows == 8) {
      // this half's two K steps of the slice, 2 g and 2 g + 1; B: rows
      // mr, K chunks 4 g + mi (both steps' fragments in one load)
      uint32_t bq[4];
      ldmatrix_x4(bq, rsm + swz(mr, 8 * slice + 4 * g + mi, dpad));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t af[4];
        ldmatrix_x4(af, st + swz(16 * sw + 8 * (mi & 1) + mr,
                                 2 * (2 * g + h) + (mi >> 1), kSlice));
        mma_s8(acc[0], af, bq[2 * h], bq[2 * h + 1]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kSlice / 32; ++kk) {
        // A: slots 16 sw + 8 (mi % 2) + mr, K chunk 2 kk + mi / 2
        uint32_t af[4];
        ldmatrix_x4(af, st + swz(16 * sw + 8 * (mi & 1) + mr,
                                 2 * kk + (mi >> 1), kSlice));
        uint32_t bq[4];
        if constexpr (kFpw == 1) {
          // both halves' rows in one load; this warp multiplies its own
          ldmatrix_x4(bq, rsm + swz(8 * (mi >> 1) + mr,
                                    8 * slice + 2 * kk + (mi & 1), dpad));
          mma_s8(acc[0], af, g ? bq[2] : bq[0], g ? bq[3] : bq[1]);
        } else {
#pragma unroll
          for (int f = 0; f < kFpw; f += 2) {
            // B: rows 8 (F + mi / 2) + mr, K chunk 2 kk + mi % 2
            const int fr = g * kFpw + f;
            ldmatrix_x4(bq, rsm + swz(8 * (fr + (mi >> 1)) + mr,
                                      8 * slice + 2 * kk + (mi & 1), dpad));
            mma_s8(acc[f], af, bq[0], bq[1]);
            mma_s8(acc[f + 1], af, bq[2], bq[3]);
          }
        }
      }
    }
    if (slice != a.n_slices - 1) continue;

    // ---- epilogue of the tile: descale, mask, into the strip
    bool writes = true;
    if constexpr (kRows == 8) {
      // warps 4-7 hand their K half to warps 0-3 (int32: exact in any
      // order); xacc is rewritten only after the next step's barrier
      int* xs = xacc + sw * 4 * 32;
      if (g == 1) {
#pragma unroll
        for (int e = 0; e < 4; ++e) xs[e * 32 + lane] = acc[0][e];
      }
      __syncthreads();
      if (g == 0) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[0][e] += xs[e * 32 + lane];
      }
      writes = g == 0;
    }
#pragma unroll
    for (int f = 0; f < kFpw; ++f) {
#pragma unroll
      for (int e = 0; e < 2 && writes; ++e) {
        const int q = (kRows == 8 ? 0 : 8 * (g * kFpw + f)) +
                      2 * (lane & 3) + e;
        const float rq = rri[q];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (ls[h] < L) {
            float s = __fadd_rn(
                __fmul_rn(__fmul_rn(__int2float_rn(acc[f][2 * h + e]), rq),
                          ri[h]),
                md[h]);
            if (!live[h] || ls[h] == i0 + q) s = kNegInf;
            strip[q * sstride + ls[h]] = s;
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][e] = 0;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (CORTEX_KNN_PARTS == 1) {         // profiling: keep the strip live
    if (tid == 0) a.out[blockIdx.x] = __float_as_int(strip[i0 % L]);
    return;
  }

  // ---- selection: a warp a row, over the strip
  const int n_sort = sort_len(a.r);
  const int per_warp = kBins * 4 + n_sort * 8;
  uint32_t* hist = reinterpret_cast<uint32_t*>(region + warp * per_warp);
  unsigned long long* buf =
      reinterpret_cast<unsigned long long*>(region + warp * per_warp +
                                            kBins * 4);
  const unsigned lt_mask = (1u << lane) - 1u;
  const uint32_t dead_key = order_key(kDeadScore);
  for (int q = warp; q < kRows && i0 + q < L; q += kWarps) {
    const float* srow = strip + q * sstride;
    // radix select of the r-th largest key: `want` of the keys that
    // match `prefix` under `pmask` are still to be taken
    uint32_t prefix = 0u, pmask = 0u;
    int want = a.r;
    for (int shift = 24; shift >= 0; shift -= 8) {
      for (int b = lane; b < kBins; b += 32) hist[b] = 0u;
      __syncwarp();
      for (int j = lane; j < L; j += 32) {
        const uint32_t k = order_key(srow[j]);
        if ((k & pmask) == prefix) atomicAdd(hist + ((k >> shift) & 255u), 1u);
      }
      __syncwarp();
      // lane covers bins 255 - 8 lane - t, t = 0..7 (the top bins first)
      int cnt[8];
      int cs = 0;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        cnt[t] = static_cast<int>(hist[255 - 8 * lane - t]);
        cs += cnt[t];
      }
      int incl = cs;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      const int src = __ffs(__ballot_sync(0xffffffffu, incl >= want)) - 1;
      int digit = 0, above = 0;
      if (lane == src) {
        int run = incl - cs;
        bool found = false;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          if (!found && run + cnt[t] >= want) {
            digit = 255 - 8 * lane - t;
            above = run;
            found = true;
          }
          run += cnt[t];
        }
      }
      digit = __shfl_sync(0xffffffffu, digit, src);
      above = __shfl_sync(0xffffffffu, above, src);
      want -= above;
      prefix |= static_cast<uint32_t>(digit) << shift;
      pmask |= 0xffu << shift;
      __syncwarp();
    }
    // compact every key above T and the first `want` keys equal to T as
    // (key << 32 | ~slot): descending words are (score desc, slot asc);
    // the buffer's tail past r holds 0, which sorts last
    const uint32_t kt = prefix;
    int taken = 0, eq_seen = 0;
    for (int base = 0; base < L; base += 32) {
      const int j = base + lane;
      const uint32_t k = j < L ? order_key(srow[j]) : 0u;
      const bool eq = j < L && k == kt;
      const unsigned eqb = __ballot_sync(0xffffffffu, eq);
      const bool sel =
          (j < L && k > kt) || (eq && eq_seen + __popc(eqb & lt_mask) < want);
      const unsigned sb = __ballot_sync(0xffffffffu, sel);
      if (sel) {
        buf[taken + __popc(sb & lt_mask)] =
            (static_cast<unsigned long long>(k) << 32) |
            static_cast<unsigned>(~j);
      }
      taken += __popc(sb);
      eq_seen += __popc(eqb);
    }
    for (int e = a.r + lane; e < n_sort; e += 32) buf[e] = 0ull;
    __syncwarp();
    // bitonic sort, descending, of the warp's n_sort words
    for (int size = 2; size <= n_sort; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int e = lane; e < n_sort; e += 32) {
          const int o = e ^ stride;
          if (o > e) {
            const unsigned long long x = buf[e], y = buf[o];
            if ((e & size) == 0 ? x < y : x > y) {
              buf[e] = y;
              buf[o] = x;
            }
          }
        }
        __syncwarp();
      }
    }
    int32_t* out = a.out + (cbase + i0 + q) * a.r;
    for (int e = lane; e < a.r; e += 32) {
      const unsigned long long w = buf[e];
      const uint32_t k = static_cast<uint32_t>(w >> 32);
      const int slot = static_cast<int>(~static_cast<uint32_t>(w));
      out[e] = k > dead_key ? __ldg(a.slot_rows + cbase + slot) : -1;
    }
    __syncwarp();
  }
}

using KnnKernel = void (*)(KnnArgs);

template <int kRows>
KnnKernel knn_kernel(bool aligned) {
  return aligned ? block_knn_kernel<kRows, true>
                 : block_knn_kernel<kRows, false>;
}

KnnKernel knn_kernel_for(int rows, bool aligned) {
  if (rows == 64) return knn_kernel<64>(aligned);
  if (rows == 32) return knn_kernel<32>(aligned);
  if (rows == 16) return knn_kernel<16>(aligned);
  return knn_kernel<8>(aligned);
}

// The most rows a block (64, 32, 16 or 8) whose shared memory fits the
// current device next to the kernel's static shared memory; 0 if none.
int pick_rows(int l_count, int d, int r, bool aligned, cudaError_t* err) {
  DeviceLimits lim;
  *err = device_limits(&lim);
  if (*err != cudaSuccess) return 0;
  for (int rows : {64, 32, 16, 8}) {
    cudaFuncAttributes attr;
    *err = cudaFuncGetAttributes(
        &attr, reinterpret_cast<const void*>(knn_kernel_for(rows, aligned)));
    if (*err != cudaSuccess) return 0;
    if (smem_bytes(rows, l_count, d, r) + attr.sharedSizeBytes <=
        static_cast<size_t>(lim.smem_optin)) {
      return rows;
    }
  }
  return 0;
}

}  // namespace

// Rows a block the launch would take at (L, d, r), 0 when no block fits
// the current device's shared memory, or -(cudaError_t) on a runtime
// error. The binding raises ValueError on 0.
extern "C" int cortex_block_knn_rows(int l_count, int d, int r,
                                     int aligned) {
  cudaError_t err = cudaSuccess;
  const int rows = pick_rows(l_count, d, r, aligned != 0, &err);
  return err != cudaSuccess ? -static_cast<int>(err) : rows;
}

// Enqueue N1 on `stream`; returns the cudaError_t of the launch (0 =
// success). The caller has checked shapes, types, devices and that
// cortex_block_knn_rows is positive; `aligned` = d % 16 == 0 with a
// 16-byte aligned emb.
extern "C" int cortex_block_knn_launch(const void* emb, const void* rinv,
                                       const void* slot_rows,
                                       const void* mud, void* out, int ch,
                                       int l_count, int d, int r,
                                       int aligned, void* stream) {
  if (ch == 0 || l_count == 0 || r == 0) return 0;
  cudaError_t err = cudaSuccess;
  const int rows = pick_rows(l_count, d, r, aligned != 0, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows == 0) return static_cast<int>(cudaErrorInvalidValue);
  KnnArgs a;
  a.emb = static_cast<const int8_t*>(emb);
  a.rinv = static_cast<const float*>(rinv);
  a.slot_rows = static_cast<const int32_t*>(slot_rows);
  a.mud = static_cast<const float*>(mud);
  a.out = static_cast<int32_t*>(out);
  a.l_count = l_count;
  a.d = d;
  a.r = r;
  a.n_slices = (d + kSlice - 1) / kSlice;
  a.n_tiles = (l_count + kTileSlots - 1) / kTileSlots;
  a.row_tiles = (l_count + rows - 1) / rows;
  const size_t smem = smem_bytes(rows, l_count, d, r);
  const KnnKernel k = knn_kernel_for(rows, aligned != 0);
  DeviceLimits lim;
  int per_sm = 0;
  err = fit_kernel(reinterpret_cast<const void*>(k), kThreads, smem, &lim,
                   &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t grid = static_cast<int64_t>(ch) * a.row_tiles;
  k<<<static_cast<unsigned>(grid), kThreads, smem,
      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
