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
// What bounds it: fp32 operations at BGE-small's shapes. A (query, key)
// pair costs 2 * dh FMAs (the score and its share of the context), so a
// head of S = 512 does 16.8M FMAs on 256 KB of q, k, v and ctx; the
// card's 67 TFLOP/s fp32 rate is reached past S ~ 64. Tensor cores are
// not used: TF32 would break parity with the fp32 reference.
//
// What the design does about it: the [B, H, S, S] scores never leave
// the block (the plain version writes and reads them about four times:
// 805 MB a layer at B = 64, S = 512). A block takes kRows query rows of
// one (batch, head); each thread keeps its query row and its context sum
// in registers, and the block walks the keys in tiles of kKeys rows of K
// and V staged in shared memory (every thread reads the same key at the
// same time: a broadcast, one 16-byte load for four FMAs). The softmax
// is online: scores of 8 keys at a time, the running max raised and the
// sums rescaled only when a chunk's max exceeds it. A masked key scores
// exactly -1e30 (its dot is far below the bias's ulp), so exp of it less
// the max underflows to exactly 0 once any unmasked key has been seen;
// keys masked before that are scaled by exp(-1e30 - max) = 0 when the
// first unmasked key arrives. So an unmasked row's output does not
// depend on the values at masked keys, bit for bit, and a row with every
// key masked averages all of them, as the reference's softmax does.
// exp is __expf (ex2.approx), within the stated tolerance of the plain
// version. The launch is checked with cudaGetLastError; nothing
// synchronises.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kKeys = 64;     // key rows staged a tile
constexpr int kChunk = 8;     // keys scored together (online-softmax step)
constexpr int kMaxSeq = 512;  // the mask row staged whole

struct Strides {
  int64_t b, h, s;            // in floats; rows are dense and 16-byte aligned
};

template <int kDh>
__device__ __forceinline__ float dot_row(const float (&q)[kDh],
                                         const float4* k) {
  float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
  for (int c = 0; c < kDh / 4; c += 2) {
    const float4 x = k[c], y = k[c + 1];
    a0 = fmaf(q[4 * c], x.x, a0);
    a0 = fmaf(q[4 * c + 1], x.y, a0);
    a0 = fmaf(q[4 * c + 2], x.z, a0);
    a0 = fmaf(q[4 * c + 3], x.w, a0);
    a1 = fmaf(q[4 * c + 4], y.x, a1);
    a1 = fmaf(q[4 * c + 5], y.y, a1);
    a1 = fmaf(q[4 * c + 6], y.z, a1);
    a1 = fmaf(q[4 * c + 7], y.w, a1);
  }
  return a0 + a1;
}

template <int kDh, int kRows>
__global__ void __launch_bounds__(kRows)
    masked_attention_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ mask_bias, int heads,
                            int seq, Strides qs, Strides ks, Strides vs,
                            float scale, float* __restrict__ out) {
  constexpr int kVec = kDh / 4;
  __shared__ float4 k_tile[kKeys * kVec];
  __shared__ float4 v_tile[kKeys * kVec];
  __shared__ float bias[kMaxSeq];

  const int bh = blockIdx.x;
  const int bi = bh / heads, hi = bh % heads;
  const int row = blockIdx.y * kRows + threadIdx.x;
  const bool active = row < seq;

  for (int i = threadIdx.x; i < seq; i += kRows) {
    bias[i] = mask_bias[static_cast<int64_t>(bi) * seq + i];
  }
  float qr[kDh], acc[kDh];
  if (active) {
    const float4* qp = reinterpret_cast<const float4*>(
        q + bi * qs.b + hi * qs.h + row * qs.s);
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      const float4 t = __ldg(qp + c);
      qr[4 * c] = t.x;
      qr[4 * c + 1] = t.y;
      qr[4 * c + 2] = t.z;
      qr[4 * c + 3] = t.w;
    }
  }
#pragma unroll
  for (int d = 0; d < kDh; ++d) acc[d] = 0.0f;
  float m = -CUDART_INF_F, l = 0.0f;

  const float* kb = k + bi * ks.b + hi * ks.h;
  const float* vb = v + bi * vs.b + hi * vs.h;
  for (int t0 = 0; t0 < seq; t0 += kKeys) {
    const int nk = min(kKeys, seq - t0);
    __syncthreads();            // the previous tile is read; bias is staged
    for (int i = threadIdx.x; i < nk * kVec; i += kRows) {
      const int j = i / kVec, c = i % kVec;
      k_tile[i] = __ldg(reinterpret_cast<const float4*>(
                            kb + (t0 + j) * ks.s) + c);
      v_tile[i] = __ldg(reinterpret_cast<const float4*>(
                            vb + (t0 + j) * vs.s) + c);
    }
    __syncthreads();
    if (!active) continue;
    for (int j0 = 0; j0 < nk; j0 += kChunk) {
      float s[kChunk];
      float mc = -CUDART_INF_F;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int j = j0 + jj;
        s[jj] = j < nk ? dot_row<kDh>(qr, k_tile + j * kVec) * scale +
                             bias[t0 + j]
                       : -CUDART_INF_F;
        mc = fmaxf(mc, s[jj]);
      }
      if (mc > m) {
        const float alpha = __expf(m - mc);
        l *= alpha;
#pragma unroll
        for (int d = 0; d < kDh; ++d) acc[d] *= alpha;
        m = mc;
      }
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int j = j0 + jj;
        if (j < nk) {
          const float p = __expf(s[jj] - m);
          l += p;
          const float4* vr = v_tile + j * kVec;
#pragma unroll
          for (int c = 0; c < kVec; ++c) {
            const float4 t = vr[c];
            acc[4 * c] = fmaf(p, t.x, acc[4 * c]);
            acc[4 * c + 1] = fmaf(p, t.y, acc[4 * c + 1]);
            acc[4 * c + 2] = fmaf(p, t.z, acc[4 * c + 2]);
            acc[4 * c + 3] = fmaf(p, t.w, acc[4 * c + 3]);
          }
        }
      }
    }
  }
  if (!active) return;
  const float inv = 1.0f / l;
  float4* op = reinterpret_cast<float4*>(
      out + ((static_cast<int64_t>(bi) * seq + row) * heads + hi) * kDh);
#pragma unroll
  for (int c = 0; c < kVec; ++c) {
    op[c] = make_float4(acc[4 * c] * inv, acc[4 * c + 1] * inv,
                        acc[4 * c + 2] * inv, acc[4 * c + 3] * inv);
  }
}

template <int kDh, int kRows>
int launch(const void* q, const void* k, const void* v, const void* bias,
           int batch, int heads, int seq, Strides qs, Strides ks, Strides vs,
           float scale, void* out, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(batch) * heads,
                  (seq + kRows - 1) / kRows);
  masked_attention_kernel<kDh, kRows><<<grid, kRows, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias), heads,
      seq, qs, ks, vs, scale, static_cast<float*>(out));
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
  if (dh == 32) {
    return launch<32, 128>(q, k, v, mask_bias, batch, heads, seq, qs, ks, vs,
                           scale, out, st);
  }
  if (dh == 64) {
    return launch<64, 64>(q, k, v, mask_bias, batch, heads, seq, qs, ks, vs,
                          scale, out, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
