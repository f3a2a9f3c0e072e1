// E2, the text encoder's masked attention (ops/encoder.py), for sm_90a.
//
// Replaces the XLA fusions of the attention lines of `_encoder_layer`
// (cortex_tpu/models/encoder.py:216-221):
//     ctx = softmax(q k^T / sqrt(dh) + mask_bias[b, None, None, :]) v
// for q, k, v [B, H, S, dh] float32 (any strides with 16-byte rows; the
// encoder passes views of its [B*S, 3h] Q|K|V product) and mask_bias
// [B, S] float32 (0 or -1e30). ctx is written as [B, S, H, dh], which is
// the [B*S, h] layout the output product reads.
//
// What bounds it: operations. A (query, kept key) pair costs 4 * dh
// flops (the score and its share of the context): 2.1 GFLOP for one
// head of S = 512 against 4 MB of q, k, v and ctx. On the CUDA cores
// (67 TFLOP/s fp32) that is 32 us a head; the tensor cores take TF32 at
// 495 TFLOP/s, and three TF32 products per fp32 product (3xTF32, below)
// still leave 165. Keys that the mask removes add nothing to the
// reference's result, so the work that counts is that of kept keys.
//
// What the design does about it (FlashAttention-2's pattern):
// - A block of 4 warps takes 64 query rows of one (batch, head), 16 rows
//   a warp; the scores never leave the registers.
// - Tile skip: the block stages the row's mask bias and marks which
//   32-key tiles hold a kept key (bias above -1e29); it walks only those.
//   In a walked tile the K and V rows of masked keys are set to zeros,
//   so a masked score is exactly 0 + bias and its weight exactly 0: the
//   inputs of every product, and so a kept query row's output, do not
//   depend on what masked keys hold, bit for bit. A row with no kept key
//   walks every tile with its real K and V, and averages v as the
//   reference's softmax over equal scores does.
// - K and V tiles are copied with cp.async, 16 bytes a thread, into two
//   stages: the next walked tile's copy runs under the current tile's
//   math. Tile 0's copy starts before the mask is read (nearly every row
//   keeps key 0); each thread zeroes its own chunks of masked keys once
//   its copy has landed. Shared rows are dh + 4 floats (16-byte rows,
//   and the fragment loads below hit 32 distinct banks).
// - S = Q K^T and O += P V run on mma.sync m16n8k8 TF32 with fp32
//   accumulation. Q is split once into two shared planes (high parts,
//   rests) that the warps read by ldmatrix.x4 (an 8 x 4 block of fp32
//   words is an 8 x 8 block of b16), as they read K; K and V are split
//   in registers as their fragments are loaded. P goes from the
//   accumulator layout to the A operand without a shuffle: the
//   accumulator holds keys 2t and 2t + 1 of each 8, which the A operand
//   takes as its columns t and t + 4, and V's rows are read in the same
//   order (2t, 2t + 1).
// - The online softmax runs on the fragments: row max and row sum by
//   shuffles within a quad, exp2 on scores that Q and the bias carry
//   pre-scaled by log2(e) / sqrt(dh) and log2(e) (ex2.approx, as __expf).
// - One tile shape for dh 32 and 64.
// Why this shape (each choice timed on the H100 against the others):
// 32-key tiles ran faster than 64-key ones at every timed shape and skip
// at a finer grain; Q in shared memory instead of
// registers leaves room for 5 blocks an SM at dh 32; splitting K and V
// once a block into shared planes ran slower (the extra pass and
// barrier cost more than the splits it saves); two 16-row tiles a warp
// ran faster at S 512 with every key kept but slower at S 128 and at
// the embedder's real lengths.
//
// The 3xTF32 error argument. Each fp32 operand x is split into
// hi = x rounded to TF32 (11 significant bits) and lo = x - hi (exact in
// fp32, |lo| <= 2^-11 |x|), which the mma reads truncated to TF32. Then
// a*b ~ hi_a hi_b + hi_a lo_b + lo_a hi_b: the dropped lo_a lo_b and the
// truncations of lo are each below 2^-21 |a b|, about 8 fp32 ulps of
// the product; the products themselves are exact in the mma, which adds
// them in fp32, truncating. A score's small cross products are summed
// apart from its large products (onto the bias) and the two added once
// the score is complete, so that the large sum's rounding does not
// swallow them; in P V each k-step adds its small products before its
// large one, and a tile's P V is summed apart and added to o with a
// rounded fma (chained into o, the truncations of up to 16 tiles' adds
// all lean one way, and at S 512 came near ATTN_ATOL). On N(0, 1)
// inputs the result is within ATTN_ATOL (1e-5) of the plain fp32
// version. With |q| and |k| 10x larger (scores of std ~100) the plain
// fp32 version is itself ~1e-4 from the float64 answer, and this kernel
// no further from it.
//
// The launch is checked with cudaGetLastError; nothing synchronises.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>
#include <cstdint>

#include "device_common.cuh"

namespace {

constexpr int kRows = 64;           // query rows a block: 4 warps of 16
constexpr int kThreads = 128;
constexpr int kKeys = 32;           // key rows a tile
constexpr int kMaxSeq = 512;        // the mask row staged whole
constexpr int kMaxTiles = kMaxSeq / kKeys;
constexpr float kMaskedBelow = -1e29f;   // the reference's bias is -1e30
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kMaxTiles <= 32, "a walk is one 32-bit mask of tiles");

struct Strides {
  int64_t b, h, s;            // in floats; rows are dense and 16-byte aligned
};

template <int kDh>
struct Shape {
  static constexpr int kStride = kDh + 4;          // floats a shared row
  static constexpr int kTile = kKeys * kStride;    // floats of one K or V tile
  // K and V in 2 stages, then Q's TF32 high parts and rests
  static constexpr size_t kSmem =
      (2 * 2 * kTile + 2 * kRows * kStride) * sizeof(float);
  static constexpr int kSteps = kDh / 8;           // k-steps of Q K^T
  static constexpr int kRowChunks = kDh / 4;       // 16-byte chunks a row
  static constexpr int kLoadRows = kThreads / kRowChunks;   // rows a pass
};

// x = hi + lo: hi is x rounded to TF32 (to nearest, ties away), lo the
// exact rest, whose low 13 bits the mma ignores
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a (16 x 8 TF32, row) * b (8 x 8 TF32, col), fp32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// blocks an SM: shared memory holds 5 at dh 32 (39 KB each) and 3 at dh
// 64 (72 KB); the bound caps registers to fit them (96 and 153 used)
template <int kDh>
__global__ void __launch_bounds__(kThreads, kDh == 32 ? 5 : 3)
    masked_attention_tc_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               const float* __restrict__ mask_bias,
                               int heads, int seq, int row_blocks,
                               int heads_per_y, int64_t batch_heads,
                               Strides qs, Strides ks, Strides vs,
                               float q_scale, float* __restrict__ out) {
  using S = Shape<kDh>;
  extern __shared__ __align__(16) float kv[];   // [stage][K, V][key][kStride]
  __shared__ __align__(16) float bias[kMaxSeq];  // log2(e) * bias; -inf past S
  __shared__ uint32_t kept_bits[kMaxSeq / 32];

  // row blocks of one (batch, head) are neighbours in launch order, so
  // its K and V come from the L2 after the first block reads them
  const int64_t bh = static_cast<int64_t>(blockIdx.y) * heads_per_y +
                     blockIdx.x / row_blocks;
  if (bh >= batch_heads) return;
  const int64_t bi = bh / heads;
  const int hi = static_cast<int>(bh % heads);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tiles = (seq + kKeys - 1) / kKeys;

  // a thread copies 16-byte chunk `lc` of rows lr, lr + kLoadRows, ... of
  // a tile: its rows below seq as they are, the others as zeros
  const int lr = tid / S::kRowChunks, lc = 4 * (tid % S::kRowChunks);
  const float* kb = k + bi * ks.b + hi * ks.h + lc;
  const float* vb = v + bi * vs.b + hi * vs.h + lc;
  auto load_tile = [&](int j, int stage) {
    float* dst = kv + 2 * stage * S::kTile + lr * S::kStride + lc;
    int key = j * kKeys + lr;
    const float* ksrc = kb + key * ks.s;
    const float* vsrc = vb + key * vs.s;
#pragma unroll
    for (int i = 0; i < kKeys / S::kLoadRows; ++i) {
      const bool in = key < seq;
      cortex_dev::cp_async16(dst, in ? ksrc : kb, in ? 16 : 0);
      cortex_dev::cp_async16(dst + S::kTile, in ? vsrc : vb, in ? 16 : 0);
      dst += S::kLoadRows * S::kStride;
      ksrc += S::kLoadRows * ks.s;
      vsrc += S::kLoadRows * vs.s;
      key += S::kLoadRows;
    }
    cortex_dev::cp_async_commit();
  };
  load_tile(0, 0);          // nearly always walked: its copy runs under
                            // the mask's and Q's loads

#pragma unroll
  for (int r = 0; r < kMaxSeq / kThreads; ++r) {
    const int i = r * kThreads + tid;
    const float b = i < seq ? __ldg(mask_bias + bi * seq + i) : -CUDART_INF_F;
    bias[i] = b * kLog2e;
    const uint32_t bits = __ballot_sync(0xffffffffu, b > kMaskedBelow);
    if (lane == 0) kept_bits[i >> 5] = bits;
  }

  // the block's 64 query rows, pre-scaled and split once, as two planes
  // of the same layout as a K tile; warps read their A fragments there
  float* const qhi = kv + 2 * 2 * S::kTile;
  float* const qlo = qhi + kRows * S::kStride;
  const int row0 = (blockIdx.x % row_blocks) * kRows;
  {
    const float* qb = q + bi * qs.b + hi * qs.h + lc;
#pragma unroll
    for (int i = 0; i < kRows / S::kLoadRows; ++i) {
      const int r = lr + i * S::kLoadRows, row = row0 + r;
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (row < seq) x = __ldg(reinterpret_cast<const float4*>(qb + row * qs.s));
      uint4 h, l;
      split(x.x * q_scale, h.x, l.x);
      split(x.y * q_scale, h.y, l.y);
      split(x.z * q_scale, h.z, l.z);
      split(x.w * q_scale, h.w, l.w);
      *reinterpret_cast<uint4*>(qhi + r * S::kStride + lc) = h;
      *reinterpret_cast<uint4*>(qlo + r * S::kStride + lc) = l;
    }
  }
  const int ra = row0 + warp * 16 + g;      // this thread's rows: ra, ra + 8
  // lane's row address for an x4 ldmatrix of a 16 x 8 A fragment: rows
  // 0-7 / 8-15 (lane bit 3), columns 0-3 / 4-7 (lane bit 4)
  const int qa = (warp * 16 + (lane & 15)) * S::kStride + 4 * (lane >> 4);
  __syncthreads();

  uint32_t walk = 0;
  for (int j = 0; j < tiles; ++j) {
    uint32_t any = 0;
#pragma unroll
    for (int w = 0; w < kKeys / 32; ++w) any |= kept_bits[j * kKeys / 32 + w];
    walk |= any ? 1u << j : 0u;
  }
  const bool zero_masked = walk != 0;
  if (!zero_masked) walk = (1u << tiles) - 1u;   // no kept key: every tile

  float o[S::kSteps][4];
#pragma unroll
  for (int n = 0; n < S::kSteps; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  }
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.0f, l1 = 0.0f;

  int cur = __ffs(walk) - 1;
  walk &= walk - 1;
  if (cur != 0) {           // tile 0 holds no kept key: drop its copy
    cortex_dev::cp_async_wait<0>();
    load_tile(cur, 0);
  }
  for (int it = 0; cur >= 0; ++it) {
    const int stage = it & 1;
    const int next = walk ? __ffs(walk) - 1 : -1;
    if (next >= 0) {
      walk &= walk - 1;
      load_tile(next, stage ^ 1);
    } else {
      cortex_dev::cp_async_commit();
    }
    cortex_dev::cp_async_wait<1>();
    if (zero_masked) {      // this thread's chunks of masked keys -> 0
      float* dst = kv + 2 * stage * S::kTile + lr * S::kStride + lc;
#pragma unroll
      for (int i = 0; i < kKeys / S::kLoadRows; ++i) {
        const int key = cur * kKeys + lr + i * S::kLoadRows;
        if (!((kept_bits[key >> 5] >> (key & 31)) & 1u)) {
          const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          *reinterpret_cast<float4*>(dst) = zero;
          *reinterpret_cast<float4*>(dst + S::kTile) = zero;
        }
        dst += S::kLoadRows * S::kStride;
      }
    }
    __syncthreads();                 // tile `cur` has landed for every warp
    const float* kt = kv + 2 * stage * S::kTile;
    const float* vt = kt + S::kTile;
    const int key0 = cur * kKeys;

    // s = Q K^T + bias for kKeys / 8 columns of 8 keys: s[n][0..1] row g,
    // keys 2t and 2t + 1 of column n; s[n][2..3] the same keys for row
    // g + 8. The small products accumulate onto the bias: 0 at a kept
    // key, and at a masked one it swallows them.
    constexpr int kCols = kKeys / 8;
    float s[kCols][4], big[kCols][4];
#pragma unroll
    for (int n = 0; n < kCols; ++n) {
      const float2 bb =
          *reinterpret_cast<const float2*>(bias + key0 + 8 * n + 2 * t);
      s[n][0] = s[n][2] = bb.x;
      s[n][1] = s[n][3] = bb.y;
#pragma unroll
      for (int e = 0; e < 4; ++e) big[n][e] = 0.0f;
    }
#pragma unroll
    for (int kp = 0; kp < S::kSteps / 2; ++kp) {     // k-steps 2kp, 2kp + 1
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        cortex_dev::ldmatrix_x4(ah[h], qhi + qa + 16 * kp + 8 * h);
        cortex_dev::ldmatrix_x4(al[h], qlo + qa + 16 * kp + 8 * h);
      }
#pragma unroll
      for (int n = 0; n < kCols; ++n) {
        uint32_t b[4];             // b0, b1 of k-steps 2kp and 2kp + 1
        cortex_dev::ldmatrix_x4(
            b, kt + (8 * n + (lane & 7)) * S::kStride + 16 * kp +
                   4 * (lane >> 3));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t bh0, bl0, bh1, bl1;
          split(__uint_as_float(b[2 * h]), bh0, bl0);
          split(__uint_as_float(b[2 * h + 1]), bh1, bl1);
          mma_tf32(s[n], al[h], bh0, bh1);
          mma_tf32(s[n], ah[h], bl0, bl1);
          mma_tf32(big[n], ah[h], bh0, bh1);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < kCols; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] += big[n][e];
    }

    // online softmax: the quad holds a row's 64 scores
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < kCols; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float a0 = ex2(m0 - mx0), a1 = ex2(m1 - mx1);   // 0 on the first
    m0 = mx0;
    m1 = mx1;
    float ls0 = 0.0f, ls1 = 0.0f;
#pragma unroll
    for (int n = 0; n < kCols; ++n) {
      s[n][0] = ex2(s[n][0] - m0);
      s[n][1] = ex2(s[n][1] - m0);
      s[n][2] = ex2(s[n][2] - m1);
      s[n][3] = ex2(s[n][3] - m1);
      ls0 += s[n][0] + s[n][1];
      ls1 += s[n][2] + s[n][3];
    }
    l0 = l0 * a0 + ls0;
    l1 = l1 * a1 + ls1;

    // o = o * alpha + P V: P's k-step j is score column j, taken as it
    // lies (keys 2t, 2t + 1 as A columns t, t + 4); V's rows likewise.
    // The tile's P V is summed apart and added to o once, rounded to
    // nearest: o itself never takes the mma's truncating adds.
    float pv[S::kSteps][4];
#pragma unroll
    for (int n = 0; n < S::kSteps; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[n][e] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      uint32_t ah[4], al[4];
      split(s[j][0], ah[0], al[0]);
      split(s[j][2], ah[1], al[1]);
      split(s[j][1], ah[2], al[2]);
      split(s[j][3], ah[3], al[3]);
      const float* v0 = vt + (8 * j + 2 * t) * S::kStride + g;
#pragma unroll
      for (int n = 0; n < S::kSteps; ++n) {
        uint32_t bh0, bl0, bh1, bl1;
        split(v0[8 * n], bh0, bl0);
        split(v0[S::kStride + 8 * n], bh1, bl1);
        mma_tf32(pv[n], al, bh0, bh1);
        mma_tf32(pv[n], ah, bl0, bl1);
        mma_tf32(pv[n], ah, bh0, bh1);
      }
    }
#pragma unroll
    for (int n = 0; n < S::kSteps; ++n) {
      o[n][0] = o[n][0] * a0 + pv[n][0];
      o[n][1] = o[n][1] * a0 + pv[n][1];
      o[n][2] = o[n][2] * a1 + pv[n][2];
      o[n][3] = o[n][3] * a1 + pv[n][3];
    }
    __syncthreads();                 // every warp is done with this stage
    cur = next;
  }

  const float inv0 = 1.0f / quad_sum(l0), inv1 = 1.0f / quad_sum(l1);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = ra + 8 * e;
    if (row >= seq) continue;
    const float inv = e ? inv1 : inv0;
    float* op = out + ((bi * seq + row) * heads + hi) * kDh + 2 * t;
#pragma unroll
    for (int n = 0; n < S::kSteps; ++n) {
      *reinterpret_cast<float2*>(op + 8 * n) =
          make_float2(o[n][2 * e] * inv, o[n][2 * e + 1] * inv);
    }
  }
}

template <int kDh>
int launch(const void* q, const void* k, const void* v, const void* bias,
           int batch, int heads, int seq, Strides qs, Strides ks, Strides vs,
           float q_scale, void* out, cudaStream_t st) {
  constexpr size_t smem = Shape<kDh>::kSmem;
  const void* fn =
      reinterpret_cast<const void*>(&masked_attention_tc_kernel<kDh>);
  cortex_dev::DeviceLimits lim;
  int per_sm = 0;
  cudaError_t err = cortex_dev::fit_kernel(fn, kThreads, smem, &lim, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t batch_heads = static_cast<int64_t>(batch) * heads;
  const int row_blocks = (seq + kRows - 1) / kRows;
  const int per_y = static_cast<int>(std::min<int64_t>(batch_heads, 65536));
  const dim3 grid(static_cast<unsigned>(row_blocks * per_y),
                  static_cast<unsigned>((batch_heads + per_y - 1) / per_y));
  masked_attention_tc_kernel<kDh><<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias), heads,
      seq, row_blocks, per_y, batch_heads, qs, ks, vs, q_scale,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v: [batch, heads, seq, dh] with strides (b, h, s) in floats each,
// rows dense and 16-byte aligned; out: [batch, seq, heads, dh] dense.
// dh 32 or 64, 1 <= seq <= 512. Returns the launch's cudaError_t.
extern "C" int cortex_masked_attention_launch(
    const void* q, const void* k, const void* v, const void* mask_bias,
    int batch, int heads, int seq, int dh, const int64_t* q_strides,
    const int64_t* k_strides, const int64_t* v_strides, float scale,
    void* out, void* stream) {
  if (batch <= 0 || heads <= 0) return 0;
  if (seq < 1 || seq > kMaxSeq ||
      static_cast<int64_t>(batch) * heads > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides qs{q_strides[0], q_strides[1], q_strides[2]};
  const Strides ks{k_strides[0], k_strides[1], k_strides[2]};
  const Strides vs{v_strides[0], v_strides[1], v_strides[2]};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float q_scale = scale * kLog2e;    // scores in log2 units: exp2
  if (dh == 32) {
    return launch<32>(q, k, v, mask_bias, batch, heads, seq, qs, ks, vs,
                      q_scale, out, st);
  }
  if (dh == 64) {
    return launch<64>(q, k, v, mask_bias, batch, heads, seq, qs, ks, vs,
                      q_scale, out, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
