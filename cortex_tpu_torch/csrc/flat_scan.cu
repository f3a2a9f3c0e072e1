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
//   rounded once (__fdiv_rn, __fmul_rn, __fadd_rn: nvcc must not fuse the
//   multiply and the add, or the scores would differ from the plain
//   version's). The sum is an int32 __dp4a sum, exact at any d.
//
//   What bounds it: every row is d bytes read against 2*B*d integer
//   operations (B*cap*d/4 __dp4a, ~12.3 G at batch 64 and 1M x 768).
//   Measured on an H100 (PERF.md), the time grows with the number of
//   query tiles (0.63 ms for 1 tile, 4.68 ms for 8), so each tile's pass
//   over the rows, one thread streaming its own row, bounds it at ~1.3
//   TB/s effective. The design reads each row once per tile of queries,
//   never once per query: a block takes a chunk of rows x a tile of up
//   to 8 queries, with the query tiles of one chunk adjacent in the grid
//   so that the chunk is served from L2 to all of them. One thread
//   scores one row against every query of the tile (the queries sit in
//   shared memory, read as broadcasts), and the chunk's scores stay in
//   shared memory, never in device memory. Each warp then selects its query's exact
//   top-m of the chunk (m = min(cand, chunk)) with a 4-pass radix select
//   over the order-preserving integer image of the float scores, and
//   writes the partials [B, n_chunks, m]. The merge of the partials is a
//   torch.topk in the wrapper (ops/similarity.py), as the reference's
//   merge is a separate lax.top_k. The later fix: int8 tensor-core tiles
//   (mma/wgmma) over all the batch's queries, fed by coalesced loads.
//
// K2 quant_rerank: one block per query. The query sits in shared
//   memory; each warp scores candidates with coalesced row reads and f32
//   FMAs (Precision.HIGHEST's class: no TF32, no bf16), the scores stay
//   in shared memory, and a bitonic sort (score descending, candidate
//   position ascending on ties) orders them; the first min(k, cand) are
//   written, padded to k. Bound by the gather of B*cand rows (B*cand*d*4
//   bytes, ~12.6 MB at batch 64, cand 64, d 768): latency, not bandwidth.
//
// The PyTorch op binding lives in flat_scan_op.cpp, so this file never
// includes PyTorch's headers.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 8;            // queries per K1 block
constexpr int kBins = 256;
constexpr float kNegInf = -1e30f;

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

// kLoad: 16 = int4 row loads (d % 16 == 0), 4 = int loads (d % 4 == 0),
// 1 = words assembled from bytes (rows not 4-byte aligned)
template <int kLoad>
__global__ void __launch_bounds__(kThreads) quant_scan_kernel(
    const int8_t* __restrict__ emb, const float* __restrict__ rinv,
    const int8_t* __restrict__ qi8, const float* __restrict__ qs,
    const float* __restrict__ bias, float* __restrict__ out_v,
    int32_t* __restrict__ out_i, int b, int cap, int d, int tile,
    int chunk, int m) {
  extern __shared__ int smem[];
  const int nw = (d + 3) / 4;
  float* sc = reinterpret_cast<float*>(smem);          // [tile][chunk]
  int* qw = smem + tile * chunk;                      // [tile][nw]
  int* hist = qw + tile * nw;                         // [kWarps][kBins]

  const int q0 = blockIdx.x * tile;
  const int nq = min(tile, b - q0);
  const int n_chunks = gridDim.y;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * chunk;
  const int nrows = static_cast<int>(
      min(static_cast<int64_t>(chunk), static_cast<int64_t>(cap) - row0));

  // the tile's queries as int32 words, zero-padded (rows past nq stay 0)
  for (int t = threadIdx.x; t < tile * nw; t += kThreads) {
    const int qi = t / nw;
    const int w = t - qi * nw;
    uint32_t word = 0;
    if (qi < nq) {
      const int8_t* q = qi8 + static_cast<int64_t>(q0 + qi) * d;
      for (int j = 0; j < 4; ++j) {
        const int i = 4 * w + j;
        if (i < d) {
          word |= static_cast<uint32_t>(static_cast<unsigned char>(q[i]))
                  << (8 * j);
        }
      }
    }
    qw[t] = static_cast<int>(word);
  }
  float qsr[kMaxTile];
#pragma unroll
  for (int qi = 0; qi < kMaxTile; ++qi) {
    qsr[qi] = qi < nq ? qs[q0 + qi] : 1.0f;
  }
  __syncthreads();

  // phase A: one thread per row, every query of the tile
  const int n_full = d >> 2;
  for (int r = threadIdx.x; r < chunk; r += kThreads) {
    if (r >= nrows) {                   // past the corpus: never selected
      for (int qi = 0; qi < tile; ++qi) sc[qi * chunk + r] = minus_inf();
      continue;
    }
    const int64_t row = row0 + r;
    const int8_t* rp = emb + row * d;
    int acc[kMaxTile];
#pragma unroll
    for (int qi = 0; qi < kMaxTile; ++qi) acc[qi] = 0;
    if (kLoad == 16) {
      const int4* r4 = reinterpret_cast<const int4*>(rp);
      for (int v = 0; v < (d >> 4); ++v) {
        const int4 x = __ldg(r4 + v);
#pragma unroll
        for (int qi = 0; qi < kMaxTile; ++qi) {
          if (qi < tile) {
            const int* qq = qw + qi * nw + 4 * v;
            int a = __dp4a(x.x, qq[0], acc[qi]);
            a = __dp4a(x.y, qq[1], a);
            a = __dp4a(x.z, qq[2], a);
            acc[qi] = __dp4a(x.w, qq[3], a);
          }
        }
      }
    } else {
      for (int w = 0; w < n_full; ++w) {
        int x;
        if (kLoad == 4) {
          x = __ldg(reinterpret_cast<const int*>(rp) + w);
        } else {
          const unsigned char* bp =
              reinterpret_cast<const unsigned char*>(rp) + 4 * w;
          x = static_cast<int>(static_cast<uint32_t>(__ldg(bp)) |
                               (static_cast<uint32_t>(__ldg(bp + 1)) << 8) |
                               (static_cast<uint32_t>(__ldg(bp + 2)) << 16) |
                               (static_cast<uint32_t>(__ldg(bp + 3)) << 24));
        }
#pragma unroll
        for (int qi = 0; qi < kMaxTile; ++qi) {
          if (qi < tile) acc[qi] = __dp4a(x, qw[qi * nw + w], acc[qi]);
        }
      }
      for (int i = 4 * n_full; i < d; ++i) {        // the d % 4 tail
        const int x = static_cast<int>(rp[i]);
#pragma unroll
        for (int qi = 0; qi < kMaxTile; ++qi) {
          if (qi < tile) {
            const int8_t* qb = reinterpret_cast<const int8_t*>(qw + qi * nw);
            acc[qi] += x * static_cast<int>(qb[i]);
          }
        }
      }
    }
    const float ri = rinv[row];
    const float bi = bias[row];
#pragma unroll
    for (int qi = 0; qi < kMaxTile; ++qi) {
      if (qi < tile) {
        const float s = __fmul_rn(__int2float_rn(acc[qi]),
                                  __fdiv_rn(ri, qsr[qi]));
        sc[qi * chunk + r] = __fadd_rn(s, bi);
      }
    }
  }
  __syncthreads();

  // phase B: per query (one warp each), the exact top-m of the chunk
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const uint32_t lt_mask = (1u << lane) - 1u;
  int* h = hist + warp * kBins;
  for (int qi = warp; qi < nq; qi += kWarps) {
    const float* s = sc + qi * chunk;
    const int64_t out0 =
        (static_cast<int64_t>(q0 + qi) * n_chunks + blockIdx.y) * m;
    if (m >= chunk) {                   // the whole chunk is the answer
      for (int i = lane; i < chunk; i += 32) {
        out_v[out0 + i] = s[i];
        out_i[out0 + i] = i < nrows ? static_cast<int32_t>(row0 + i) : 0;
      }
      continue;
    }
    // radix select: the key of the m-th largest score, 8 bits a pass
    uint32_t prefix = 0, pmask = 0;
    int want = m;                       // rank inside the current bucket
    for (int shift = 24; shift >= 0; shift -= 8) {
      for (int i = lane; i < kBins; i += 32) h[i] = 0;
      __syncwarp();
      for (int i = lane; i < chunk; i += 32) {
        const uint32_t k = order_key(s[i]);
        if ((k & pmask) == prefix) atomicAdd(&h[(k >> shift) & 0xff], 1);
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
    // write every score above the m-th, then the first `want` equal to
    // it in row order: exactly m entries
    const int n_gt = m - want;
    int gt_seen = 0, eq_seen = 0;
    for (int base = 0; base < chunk; base += 32) {
      const int i = base + lane;
      const uint32_t k = order_key(s[i]);
      const uint32_t gt = __ballot_sync(0xffffffffu, k > prefix);
      const uint32_t eq = __ballot_sync(0xffffffffu, k == prefix);
      int slot = -1;
      if (k > prefix) {
        slot = gt_seen + __popc(gt & lt_mask);
      } else if (k == prefix) {
        const int rnk = eq_seen + __popc(eq & lt_mask);
        if (rnk < want) slot = n_gt + rnk;
      }
      if (slot >= 0) {
        out_v[out0 + slot] = s[i];
        out_i[out0 + slot] = i < nrows ? static_cast<int32_t>(row0 + i) : 0;
      }
      gt_seen += __popc(gt);
      eq_seen += __popc(eq);
    }
  }
}

// a before b in the final order: higher score, then lower position
__device__ __forceinline__ bool ranks_before(float va, int pa, float vb,
                                             int pb) {
  return va > vb || (va == vb && pa < pb);
}

template <bool kVec4>
__global__ void __launch_bounds__(kThreads) quant_rerank_kernel(
    const float* __restrict__ emb, const float* __restrict__ q,
    const float* __restrict__ cv, const int32_t* __restrict__ ci,
    float* __restrict__ out_v, int32_t* __restrict__ out_i, int cap, int d,
    int cand, int cand_p2, int k) {
  extern __shared__ float smf[];
  float* qf = smf;                                    // [d]
  float* val = qf + d;                                // [cand_p2]
  int* pos = reinterpret_cast<int*>(val + cand_p2);   // [cand_p2]
  const int b = blockIdx.x;
  const float* qb = q + static_cast<int64_t>(b) * d;
  for (int j = threadIdx.x; j < d; j += kThreads) qf[j] = qb[j];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t c0 = static_cast<int64_t>(b) * cand;
  for (int c = warp; c < cand; c += kWarps) {
    const bool valid = cv[c0 + c] > kNegInf * 0.5f;
    int row = valid ? ci[c0 + c] : 0;
    row = min(max(row, 0), cap - 1);
    const float* rp = emb + static_cast<int64_t>(row) * d;
    float acc = 0.0f;
    if (kVec4) {
      const float4* r4 = reinterpret_cast<const float4*>(rp);
      const float4* q4 = reinterpret_cast<const float4*>(qf);
      for (int j = lane; j < (d >> 2); j += 32) {
        const float4 x = __ldg(r4 + j);
        const float4 y = q4[j];
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
        acc = fmaf(x.z, y.z, acc);
        acc = fmaf(x.w, y.w, acc);
      }
    } else {
      for (int j = lane; j < d; j += 32) acc = fmaf(__ldg(rp + j), qf[j], acc);
    }
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) {
      val[c] = valid ? acc : kNegInf;
      pos[c] = c;
    }
  }
  for (int c = cand + threadIdx.x; c < cand_p2; c += kThreads) {
    val[c] = minus_inf();              // padding sorts after everything
    pos[c] = c;
  }
  __syncthreads();

  // bitonic sort of cand_p2 entries, descending by (score, -position)
  for (int size = 2; size <= cand_p2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < (cand_p2 >> 1); t += kThreads) {
        const int i = (t / stride) * stride * 2 + (t % stride);
        const int j = i + stride;
        const bool desc = (i & size) == 0;
        const bool swap = desc ? ranks_before(val[j], pos[j], val[i], pos[i])
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
  const int kk = min(k, cand);
  const int64_t o0 = static_cast<int64_t>(b) * k;
  for (int t = threadIdx.x; t < k; t += kThreads) {
    if (t < kk) {
      out_v[o0 + t] = val[t];
      out_i[o0 + t] = ci[c0 + pos[t]];
    } else {
      out_v[o0 + t] = kNegInf;
      out_i[o0 + t] = 0;
    }
  }
}

template <int kLoad>
int launch_scan(dim3 grid, size_t smem, cudaStream_t stream,
                const void* emb, const void* rinv, const void* qi8,
                const void* qs, const void* bias, void* out_v, void* out_i,
                int b, int cap, int d, int tile, int chunk, int m) {
  const cudaError_t err = cudaFuncSetAttribute(
      quant_scan_kernel<kLoad>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  quant_scan_kernel<kLoad><<<grid, kThreads, smem, stream>>>(
      static_cast<const int8_t*>(emb), static_cast<const float*>(rinv),
      static_cast<const int8_t*>(qi8), static_cast<const float*>(qs),
      static_cast<const float*>(bias), static_cast<float*>(out_v),
      static_cast<int32_t*>(out_i), b, cap, d, tile, chunk, m);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec4>
int launch_rerank(size_t smem, cudaStream_t stream, const void* emb,
                  const void* q, const void* cv, const void* ci, void* out_v,
                  void* out_i, int b, int cap, int d, int cand, int cand_p2,
                  int k) {
  const cudaError_t err = cudaFuncSetAttribute(
      quant_rerank_kernel<kVec4>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  quant_rerank_kernel<kVec4><<<b, kThreads, smem, stream>>>(
      static_cast<const float*>(emb), static_cast<const float*>(q),
      static_cast<const float*>(cv), static_cast<const int32_t*>(ci),
      static_cast<float*>(out_v), static_cast<int32_t*>(out_i), cap, d, cand,
      cand_p2, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1: enqueue the scan on `stream`; returns the cudaError_t of the launch
// (0 = success). The caller has checked shapes, types and devices and
// chosen tile, chunk and m (flat_scan_op.cpp); n_chunks = ceil(cap/chunk).
extern "C" int cortex_quant_scan_launch(
    const void* emb, const void* rinv, const void* qi8, const void* qs,
    const void* bias, void* out_v, void* out_i, int b, int cap, int d,
    int tile, int chunk, int m, void* stream) {
  if (b == 0 || cap == 0) return 0;
  const int n_chunks = (cap + chunk - 1) / chunk;
  const dim3 grid(static_cast<unsigned>((b + tile - 1) / tile),
                  static_cast<unsigned>(n_chunks));
  const size_t smem =
      (static_cast<size_t>(tile) * chunk + static_cast<size_t>(tile) *
       ((d + 3) / 4) + static_cast<size_t>(kWarps) * kBins) * sizeof(int);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % 16 == 0) {
    return launch_scan<16>(grid, smem, s, emb, rinv, qi8, qs, bias, out_v,
                           out_i, b, cap, d, tile, chunk, m);
  }
  if (d % 4 == 0) {
    return launch_scan<4>(grid, smem, s, emb, rinv, qi8, qs, bias, out_v,
                          out_i, b, cap, d, tile, chunk, m);
  }
  return launch_scan<1>(grid, smem, s, emb, rinv, qi8, qs, bias, out_v,
                        out_i, b, cap, d, tile, chunk, m);
}

// K2: enqueue the re-rank on `stream`; returns the cudaError_t of the
// launch. cand_p2 is cand rounded up to a power of two.
extern "C" int cortex_quant_rerank_launch(
    const void* emb, const void* q, const void* cv, const void* ci,
    void* out_v, void* out_i, int b, int cap, int d, int cand, int cand_p2,
    int k, void* stream) {
  if (b == 0) return 0;
  const size_t smem = static_cast<size_t>(d) * sizeof(float) +
                      static_cast<size_t>(cand_p2) * (sizeof(float) +
                                                      sizeof(int));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % 4 == 0) {
    return launch_rerank<true>(smem, s, emb, q, cv, ci, out_v, out_i, b, cap,
                               d, cand, cand_p2, k);
  }
  return launch_rerank<false>(smem, s, emb, q, cv, ci, out_v, out_i, b, cap,
                              d, cand, cand_p2, k);
}
