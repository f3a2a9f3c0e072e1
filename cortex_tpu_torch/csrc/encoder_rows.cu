// The text encoder's row programs (ops/encoder.py), for sm_90a:
//
// E1, the residual + LayerNorm. Replaces the XLA fusion of the residual
// add and `_layer_norm` (cortex_tpu/models/encoder.py:200, called at
// :222-223 and :226-227):
//     v = x[t] + r[t % P]
//     y[t] = (v - mean(v)) / sqrt(var(v) + eps) * g + b
// over rows of h float32 values, var the biased variance. x, y are
// [T, h]; r is [P, h] with T % P == 0 (P = T after a product).
//
// The embedding form, E1 with the embedding's gather in front. Replaces
// the XLA fusion of the embedding sum and its `_layer_norm`
// (cortex_tpu/models/encoder.py:236-239):
//     v = (word[clamp(ids[t])] + pos[min(t % S, P - 1)]) + type_row
//     y[t] = LN(v) * g + b
// for ids [B, S] (T = B * S rows), word [V, h], pos [P, h]. The sums
// are taken in the reference's order. An id outside [0, V) is taken as
// jnp indexing takes it: a negative id is wrapped once (id + V), then
// every id is clamped into [0, V - 1]; a position past P takes row P - 1.
//
// What bounds them: bytes. E1 reads x and r and writes y, 12 bytes a
// value, ~10 flops a value; the embedding form reads a gathered row and
// a position row and writes y. At the shapes chip_smoke.py times
// (ENC_TIMED):
//   - B 1 / S 32 (32 rows of 384: every store, search and served
//     request): 0.15 MB, 0.00004 ms of bytes; the time is the launch and
//     the chain of dependent memory trips. The first design ran
//     load x and r, two reductions, load g and b, store, on 4 SMs;
//   - B 64 / S 128 (8,192 rows) at h 384 (37.7 MB) and h 768 (75.5 MB):
//     HBM bandwidth, once reads and writes of different rows overlap.
//     The first design's 8-warp blocks (40 and 54 registers a thread:
//     6 and 4 blocks an SM) ran in 1.3 and 1.9 waves, each warp one
//     row: every warp read, then wrote, and the last wave ran on a card
//     mostly idle;
//   - the S 512 chunk (99,840 rows at h 384, 460 MB): HBM bandwidth.
//
// What the design does about it:
//   - one warp a row, the row held in the warp's registers (16-byte
//     loads, h / 128 of them a lane; rows of h % 4 == 0 on 16 bytes), so
//     each value is read once and written once;
//   - every load a row needs is issued before its first reduction: the
//     first row's x and r (word and position rows) together with the
//     vectors every row shares (g, b and the type row), so a row waits
//     on memory once, then stores (the gather adds the id's load in
//     front of its row's);
//   - blocks of 1, 2 or 4 warps (1 while T < 2 x the SM count, so that a
//     small T spreads over T SMs), and one of two forms, chosen from T
//     and what the card holds at once (its SM count and each form's
//     blocks an SM, from the occupancy calculator, read once per
//     device), so that large T keeps bytes in flight with no wave tail:
//     (0) a row a warp, the shared vectors in registers, the block
//         scheduler filling each SM as blocks end: while the card holds
//         a warp for every row (B 1 / S 32: 32 blocks of one warp), and
//         for E1 past kStridedRounds rows a warp (the S 512 chunk);
//     (1) between them: a grid of the blocks the card holds, each warp
//         taking rows with the grid's stride, the next row's loads
//         issued before this row is normalized (two rows in flight a
//         warp), the shared vectors in shared memory, loaded by the
//         block beside the first rows (B 64 / S 128: 2-4 rows a warp).
//         The embedding form keeps it at every larger T: a row's gather
//         waits on its id first, and the prefetch hides that trip
//         behind the row before, where E1's streamed rows gain little
//         from it and lose to the grid's cap past kStridedRounds (on an
//         H100 SXM, chip_smoke.py --profile, at the chunk: the
//         embedding form 0.095 ms strided against 0.119 a row a warp;
//         E1 0.164 against 0.152).
//     Holding the shared vectors in registers across a strided walk cost
//     enough occupancy (110-134 registers a thread at h 768) to lose to
//     the first design at h 768 and at the chunk; shared memory keeps
//     form 1 at 70-116.
// Mean and variance are two passes over the registers in float32 (no
// Welford): the variance is the mean of (v - mean)^2, as the reference's
// jnp.var and the plain versions compute it, so the two differ only by
// the order of the sums' additions (warp shuffles here, torch's
// reduction there). The output is spelled with __fdiv_rn / __fmul_rn /
// __fadd_rn, so nvcc contracts nothing into an FMA: (v - mean) / sd * g
// + b rounds as the plain version's separate ops do. Each launch is
// checked with cudaGetLastError; nothing synchronises.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "device_common.cuh"

namespace {

constexpr int kMaxWarps = 4;       // warps a block
constexpr int kMaxVecs = 8;        // float4s a lane: h <= 1024
// rows an E1 warp walks, at most, in the strided form before a row a
// warp takes over again (the embedding form: no limit)
constexpr int64_t kStridedRounds = 8;
constexpr int64_t kAnyRounds = INT64_MAX;

// A compile-time switch for chip_smoke.py --profile, which builds this
// file alone: -1 (the ops' build) picks the launch form from T; 0 or 1
// force that form at every T.
#ifndef CORTEX_E1_FORM
#define CORTEX_E1_FORM -1
#endif

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float4 add4(float4 a, float4 c) {
  return make_float4(__fadd_rn(a.x, c.x), __fadd_rn(a.y, c.y),
                     __fadd_rn(a.z, c.z), __fadd_rn(a.w, c.w));
}

__device__ __forceinline__ float norm_one(float v, float mean, float sd,
                                          float g, float b) {
  return __fadd_rn(__fmul_rn(__fdiv_rn(__fsub_rn(v, mean), sd), g), b);
}

// a row's two [h4] float4 vectors, kVecs a lane: the first read once and
// not again (streamed), the second through the read-only path
template <int kVecs, bool kStreamFirst>
__device__ __forceinline__ void load_pair(const float4* __restrict__ p,
                                          const float4* __restrict__ q,
                                          int lane, int h4,
                                          float4 (&a)[kVecs],
                                          float4 (&c)[kVecs]) {
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int i = lane + 32 * j;
    if (i < h4) {
      a[j] = kStreamFirst ? __ldcs(p + i) : __ldg(p + i);
      c[j] = __ldg(q + i);
    }
  }
}

// The kN vectors of h4 float4s every row shares (g, b and the
// embedding's type row): in a warp's registers (kShared false), or in
// the block's shared memory, loaded by the block together (kShared
// true). load() is called by every thread of the block.
template <int kVecs, bool kShared, int kN>
struct Cols;

template <int kVecs, int kN>
struct Cols<kVecs, false, kN> {
  float4 v[kN][kVecs];
  __device__ __forceinline__ void load(const float4* const (&src)[kN],
                                       int lane, int h4, float4*) {
#pragma unroll
    for (int n = 0; n < kN; ++n) {
#pragma unroll
      for (int j = 0; j < kVecs; ++j) {
        const int i = lane + 32 * j;
        v[n][j] = i < h4 ? __ldg(src[n] + i) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }
  __device__ __forceinline__ float4 at(int n, int j, int) const {
    return v[n][j];
  }
};

template <int kVecs, int kN>
struct Cols<kVecs, true, kN> {
  const float4* s;
  __device__ __forceinline__ void load(const float4* const (&src)[kN],
                                       int, int h4, float4* smem) {
    for (int i = threadIdx.x; i < h4; i += blockDim.x) {
#pragma unroll
      for (int n = 0; n < kN; ++n) smem[n * 32 * kMaxVecs + i] = __ldg(src[n] + i);
    }
    __syncthreads();
    s = smem;
  }
  __device__ __forceinline__ float4 at(int n, int, int i) const {
    return s[n * 32 * kMaxVecs + i];
  }
};

// LN(v) * g + b of the row the warp holds (g and b cols 0 and 1),
// stored to yr
template <int kVecs, class C>
__device__ __forceinline__ void norm_row(const float4 (&v)[kVecs],
                                         const C& cols, int lane, int h4,
                                         float eps, float4* __restrict__ yr) {
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    if (lane + 32 * j < h4) sum += (v[j].x + v[j].y) + (v[j].z + v[j].w);
  }
  const float h = static_cast<float>(h4 * 4);
  const float mean = __fdiv_rn(warp_sum(sum), h);
  float sq = 0.0f;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    if (lane + 32 * j < h4) {
      const float dx = v[j].x - mean, dy = v[j].y - mean;
      const float dz = v[j].z - mean, dw = v[j].w - mean;
      sq += (dx * dx + dy * dy) + (dz * dz + dw * dw);
    }
  }
  const float sd = __fsqrt_rn(__fadd_rn(__fdiv_rn(warp_sum(sq), h), eps));
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int i = lane + 32 * j;
    if (i < h4) {
      const float4 g = cols.at(0, j, i), b = cols.at(1, j, i);
      __stcs(yr + i, make_float4(norm_one(v[j].x, mean, sd, g.x, b.x),
                                 norm_one(v[j].y, mean, sd, g.y, b.y),
                                 norm_one(v[j].z, mean, sd, g.z, b.z),
                                 norm_one(v[j].w, mean, sd, g.w, b.w)));
    }
  }
}

// E1 over rows of h4 float4s, kVecs a lane (h <= 128 * kVecs). Each warp
// takes rows with the grid's stride; kStrided (form 1) holds g and b in
// shared memory and issues the next row's loads before this row is
// normalized.
template <int kVecs, bool kStrided>
__global__ void __launch_bounds__(32 * kMaxWarps)
    add_ln_kernel(const float4* __restrict__ x, const float4* __restrict__ r,
                  const float4* __restrict__ g, const float4* __restrict__ b,
                  int64_t rows, int h4, int64_t r_rows, float eps,
                  float4* __restrict__ y) {
  __shared__ float4 smem[kStrided ? 2 * 32 * kMaxVecs : 1];
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * warps;
  int64_t row = static_cast<int64_t>(blockIdx.x) * warps + (threadIdx.x >> 5);
  const bool active = row < rows;
  float4 xa[kVecs], ra[kVecs];
  if (active) {
    load_pair<kVecs, true>(x + row * h4, r + (row % r_rows) * h4, lane, h4,
                           xa, ra);
  }
  Cols<kVecs, kStrided, 2> cols;
  cols.load({g, b}, lane, h4, smem);
  if (!active) return;
  for (;;) {
    float4 v[kVecs];
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      if (lane + 32 * j < h4) v[j] = add4(xa[j], ra[j]);
    }
    const int64_t next = row + stride;
    if (kStrided && next < rows) {
      load_pair<kVecs, true>(x + next * h4, r + (next % r_rows) * h4, lane,
                             h4, xa, ra);
    }
    norm_row<kVecs>(v, cols, lane, h4, eps, y + row * h4);
    row = next;
    if (row >= rows) break;
    if (!kStrided) {
      load_pair<kVecs, true>(x + row * h4, r + (row % r_rows) * h4, lane,
                             h4, xa, ra);
    }
  }
}

// The embedding form, ids of type Id ([rows] = [B * S] row-major): the
// row's word row (its id clamped) and position row, and the type row
// with g and b.
template <typename Id>
__device__ __forceinline__ const float4* word_row(
    const Id* __restrict__ ids, const float4* __restrict__ word, int64_t row,
    int64_t vocab, int h4) {
  int64_t w = static_cast<int64_t>(ids[row]);
  w = w < 0 ? w + vocab : w;
  w = w < 0 ? 0 : (w >= vocab ? vocab - 1 : w);
  return word + w * h4;
}

__device__ __forceinline__ const float4* pos_row(
    const float4* __restrict__ pos, int64_t row, int64_t seq,
    int64_t pos_rows, int h4) {
  const int64_t p = row % seq;
  return pos + (p < pos_rows ? p : pos_rows - 1) * h4;
}

template <int kVecs, bool kStrided, typename Id>
__global__ void __launch_bounds__(32 * kMaxWarps)
    embed_ln_kernel(const Id* __restrict__ ids,
                    const float4* __restrict__ word,
                    const float4* __restrict__ pos,
                    const float4* __restrict__ type_row,
                    const float4* __restrict__ g,
                    const float4* __restrict__ b, int64_t rows, int64_t seq,
                    int64_t vocab, int64_t pos_rows, int h4, float eps,
                    float4* __restrict__ y) {
  __shared__ float4 smem[kStrided ? 3 * 32 * kMaxVecs : 1];
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * warps;
  int64_t row = static_cast<int64_t>(blockIdx.x) * warps + (threadIdx.x >> 5);
  const bool active = row < rows;
  float4 wa[kVecs], pa[kVecs];
  if (active) {
    load_pair<kVecs, false>(word_row(ids, word, row, vocab, h4),
                            pos_row(pos, row, seq, pos_rows, h4), lane, h4,
                            wa, pa);
  }
  Cols<kVecs, kStrided, 3> cols;
  cols.load({g, b, type_row}, lane, h4, smem);
  if (!active) return;
  for (;;) {
    float4 v[kVecs];
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int i = lane + 32 * j;
      if (i < h4) v[j] = add4(add4(wa[j], pa[j]), cols.at(2, j, i));
    }
    const int64_t next = row + stride;
    if (kStrided && next < rows) {
      load_pair<kVecs, false>(word_row(ids, word, next, vocab, h4),
                              pos_row(pos, next, seq, pos_rows, h4), lane,
                              h4, wa, pa);
    }
    norm_row<kVecs>(v, cols, lane, h4, eps, y + row * h4);
    row = next;
    if (row >= rows) break;
    if (!kStrided) {
      load_pair<kVecs, false>(word_row(ids, word, row, vocab, h4),
                              pos_row(pos, row, seq, pos_rows, h4), lane,
                              h4, wa, pa);
    }
  }
}

// The launch shape over `rows` rows (see the note at the top): warps a
// block from rows and the SM count; then the strided form (kernels[1])
// where the card holds fewer warps than rows and each warp walks at most
// `rounds` rows, else a row a warp (kernels[0]).
struct Launch {
  const void* kernel;
  int form, threads, grid;
};

cudaError_t launch_shape(const void* const (&kernels)[2], int64_t rows,
                         int64_t rounds, Launch* out) {
  cortex_dev::DeviceLimits lim;
  cudaError_t err = cortex_dev::device_limits(&lim);
  if (err != cudaSuccess) return err;
  const int64_t sms = lim.sm_count;
  const int warps = rows >= 4 * sms ? kMaxWarps : (rows >= 2 * sms ? 2 : 1);
  const int64_t need = (rows + warps - 1) / warps;
  int64_t held[2];
  for (int form = 0; form < 2; ++form) {
    int per_sm = 0;
    err = cortex_dev::fit_kernel(kernels[form], 32 * warps, 0, &lim, &per_sm);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    held[form] = sms * per_sm;
  }
  const bool strided =
      need > held[0] && (need + held[1] - 1) / held[1] <= rounds;
  const int form = CORTEX_E1_FORM < 0 ? strided : CORTEX_E1_FORM;
  *out = Launch{kernels[form], form, 32 * warps,
                static_cast<int>(form == 1 ? std::min(need, held[1]) : need)};
  return cudaSuccess;
}

struct RowArgs {             // E1
  const float4 *x, *r, *g, *b;
  int64_t rows;
  int h4;
  int64_t r_rows;
  float eps;
  float4* y;
};

struct EmbedArgs {           // the embedding form
  const void* ids;
  const float4 *word, *pos, *type_row, *g, *b;
  int64_t rows, seq, vocab, pos_rows;
  int h4;
  float eps;
  float4* y;
};

// Each launcher enqueues its kernel on st; with `plan` it only writes
// the launch shape there and launches nothing.
template <int kVecs>
int launch_add_ln(const RowArgs& a, cudaStream_t st, Launch* plan) {
  static const void* const kernels[2] = {
      reinterpret_cast<const void*>(&add_ln_kernel<kVecs, false>),
      reinterpret_cast<const void*>(&add_ln_kernel<kVecs, true>)};
  Launch l;
  const cudaError_t err = launch_shape(kernels, a.rows, kStridedRounds, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (plan != nullptr) {
    *plan = l;
    return 0;
  }
  if (l.form == 1) {
    add_ln_kernel<kVecs, true><<<l.grid, l.threads, 0, st>>>(
        a.x, a.r, a.g, a.b, a.rows, a.h4, a.r_rows, a.eps, a.y);
  } else {
    add_ln_kernel<kVecs, false><<<l.grid, l.threads, 0, st>>>(
        a.x, a.r, a.g, a.b, a.rows, a.h4, a.r_rows, a.eps, a.y);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int kVecs, typename Id>
int launch_embed(const EmbedArgs& a, cudaStream_t st, Launch* plan) {
  static const void* const kernels[2] = {
      reinterpret_cast<const void*>(&embed_ln_kernel<kVecs, false, Id>),
      reinterpret_cast<const void*>(&embed_ln_kernel<kVecs, true, Id>)};
  Launch l;
  const cudaError_t err = launch_shape(kernels, a.rows, kAnyRounds, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (plan != nullptr) {
    *plan = l;
    return 0;
  }
  const Id* ids = static_cast<const Id*>(a.ids);
  if (l.form == 1) {
    embed_ln_kernel<kVecs, true, Id><<<l.grid, l.threads, 0, st>>>(
        ids, a.word, a.pos, a.type_row, a.g, a.b, a.rows, a.seq, a.vocab,
        a.pos_rows, a.h4, a.eps, a.y);
  } else {
    embed_ln_kernel<kVecs, false, Id><<<l.grid, l.threads, 0, st>>>(
        ids, a.word, a.pos, a.type_row, a.g, a.b, a.rows, a.seq, a.vocab,
        a.pos_rows, a.h4, a.eps, a.y);
  }
  return static_cast<int>(cudaGetLastError());
}

// the launchers by kVecs - 1 = (h - 1) / 128: rows of up to 1024 values
using RowLaunch = int (*)(const RowArgs&, cudaStream_t, Launch*);
using EmbedLaunch = int (*)(const EmbedArgs&, cudaStream_t, Launch*);
constexpr RowLaunch kAddLn[8] = {
    launch_add_ln<1>, launch_add_ln<2>, launch_add_ln<3>, launch_add_ln<4>,
    launch_add_ln<5>, launch_add_ln<6>, launch_add_ln<7>, launch_add_ln<8>};
constexpr EmbedLaunch kEmbed32[8] = {
    launch_embed<1, int32_t>, launch_embed<2, int32_t>,
    launch_embed<3, int32_t>, launch_embed<4, int32_t>,
    launch_embed<5, int32_t>, launch_embed<6, int32_t>,
    launch_embed<7, int32_t>, launch_embed<8, int32_t>};
constexpr EmbedLaunch kEmbed64[8] = {
    launch_embed<1, int64_t>, launch_embed<2, int64_t>,
    launch_embed<3, int64_t>, launch_embed<4, int64_t>,
    launch_embed<5, int64_t>, launch_embed<6, int64_t>,
    launch_embed<7, int64_t>, launch_embed<8, int64_t>};

bool bad_width(int h) { return h <= 0 || h > 1024 || h % 4 != 0; }

}  // namespace

// E1 over rows x h values, h % 4 == 0 and h <= 1024, every pointer on 16
// bytes. Returns the cudaError_t of the launch (0 on success).
extern "C" int cortex_add_layer_norm_launch(const void* x, const void* r,
                                            const void* g, const void* b,
                                            int64_t rows, int h,
                                            int64_t r_rows, float eps,
                                            void* y, void* stream) {
  if (rows <= 0) return 0;
  if (bad_width(h) || r_rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const RowArgs a{static_cast<const float4*>(x), static_cast<const float4*>(r),
                  static_cast<const float4*>(g), static_cast<const float4*>(b),
                  rows, h / 4, r_rows, eps, static_cast<float4*>(y)};
  return kAddLn[(h - 1) / 128](a, static_cast<cudaStream_t>(stream),
                               nullptr);
}

// The embedding form over ids [rows / seq, seq] (int64 when ids64, else
// int32), word [vocab, h], pos [pos_rows, h], type_row, g, b [h], y
// [rows, h]; h % 4 == 0 and h <= 1024, every float pointer on 16 bytes.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int cortex_embed_layer_norm_launch(
    const void* ids, int ids64, const void* word, const void* pos,
    const void* type_row, const void* g, const void* b, int64_t rows,
    int64_t seq, int64_t vocab, int64_t pos_rows, int h, float eps, void* y,
    void* stream) {
  if (rows <= 0) return 0;
  if (bad_width(h) || seq <= 0 || vocab <= 0 || pos_rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const EmbedArgs a{ids, static_cast<const float4*>(word),
                    static_cast<const float4*>(pos),
                    static_cast<const float4*>(type_row),
                    static_cast<const float4*>(g),
                    static_cast<const float4*>(b), rows, seq, vocab, pos_rows,
                    h / 4, eps, static_cast<float4*>(y)};
  return (ids64 ? kEmbed64 : kEmbed32)[(h - 1) / 128](
      a, static_cast<cudaStream_t>(stream), nullptr);
}

// The launch form E1 (embed 0) or its embedding form (embed 1, int64
// ids when ids64, else int32) takes over `rows` rows of h values on the
// current device, or -1 when it would not launch. chip_smoke.py reports
// it beside its checks.
extern "C" int cortex_encoder_rows_form(int embed, int ids64, int64_t rows,
                                        int h) {
  if (rows <= 0 || bad_width(h)) return -1;
  Launch l;
  const int err =
      embed ? (ids64 ? kEmbed64 : kEmbed32)[(h - 1) / 128](
                  EmbedArgs{nullptr, nullptr, nullptr, nullptr, nullptr,
                            nullptr, rows, 1, 1, 1, h / 4, 0.f, nullptr},
                  nullptr, &l)
            : kAddLn[(h - 1) / 128](
                  RowArgs{nullptr, nullptr, nullptr, nullptr, rows, h / 4, 1,
                          0.f, nullptr},
                  nullptr, &l);
  return err == 0 ? l.form : -1;
}
