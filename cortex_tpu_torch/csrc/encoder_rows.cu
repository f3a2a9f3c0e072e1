// E1, the text encoder's residual + LayerNorm (ops/encoder.py), for
// sm_90a.
//
// Replaces the XLA fusion of the residual add and `_layer_norm`
// (cortex_tpu/models/encoder.py:200, called at :222-227 and :247):
//     v = x[t] + r[t % P]
//     y[t] = (v - mean(v)) / sqrt(var(v) + eps) * g + b
// over rows of h float32 values, var the biased variance. x, y are
// [T, h]; r is [P, h] with T % P == 0 (P = T after a product; P = S for
// the embedding, whose position + type rows serve every sequence).
//
// What bounds it: bytes. A row reads x and r and writes y, 12 bytes a
// value, and does ~10 flops a value; at BGE-small's h = 384 a layer of
// 8,192 tokens moves 37.7 MB (0.011 ms at 3.35 TB/s).
//
// What the design does about it: one warp a row, the row held in the
// warp's registers (16-byte loads, h / 128 of them a lane; rows of
// h % 4 == 0 on 16 bytes, which every BERT width and the wrapper's
// contiguous copies give), so x and r are read once and y written once,
// with no shared memory. Mean and
// variance are two passes over the registers in float32 (no Welford):
// the variance is the mean of (v - mean)^2, as the reference's jnp.var
// and the plain version compute it, so the two differ only by the order
// of the sums' additions (warp shuffles here, torch's reduction there).
// The output is spelled with __fdiv_rn / __fmul_rn / __fadd_rn, so nvcc
// contracts nothing into an FMA: (v - mean) / sd * g + b rounds as the
// plain version's separate ops do. The launch is checked with
// cudaGetLastError; nothing synchronises.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float norm_one(float v, float mean, float sd,
                                          float g, float b) {
  return __fadd_rn(__fmul_rn(__fdiv_rn(__fsub_rn(v, mean), sd), g), b);
}

// kVecs float4 a lane: rows of h <= 128 * kVecs values, h % 4 == 0
template <int kVecs>
__global__ void __launch_bounds__(kThreads)
    add_ln_vec4_kernel(const float4* __restrict__ x,
                       const float4* __restrict__ r,
                       const float4* __restrict__ g,
                       const float4* __restrict__ b, int64_t rows, int h4,
                       int64_t r_rows, float eps, float4* __restrict__ y) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float4* xr = x + row * h4;
  const float4* rr = r + (row % r_rows) * h4;
  float4 v[kVecs];
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int i = lane + 32 * j;
    if (i < h4) {
      const float4 a = __ldcs(xr + i);
      const float4 c = __ldg(rr + i);
      v[j] = make_float4(__fadd_rn(a.x, c.x), __fadd_rn(a.y, c.y),
                         __fadd_rn(a.z, c.z), __fadd_rn(a.w, c.w));
      sum += (v[j].x + v[j].y) + (v[j].z + v[j].w);
    }
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
  float4* yr = y + row * h4;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int i = lane + 32 * j;
    if (i < h4) {
      const float4 gg = __ldg(g + i), bb = __ldg(b + i);
      __stcs(yr + i, make_float4(norm_one(v[j].x, mean, sd, gg.x, bb.x),
                                 norm_one(v[j].y, mean, sd, gg.y, bb.y),
                                 norm_one(v[j].z, mean, sd, gg.z, bb.z),
                                 norm_one(v[j].w, mean, sd, gg.w, bb.w)));
    }
  }
}

template <int kVecs>
void launch_vec4(const void* x, const void* r, const void* g, const void* b,
                 int64_t rows, int h, int64_t r_rows, float eps, void* y,
                 int grid, cudaStream_t st) {
  add_ln_vec4_kernel<kVecs><<<grid, kThreads, 0, st>>>(
      static_cast<const float4*>(x), static_cast<const float4*>(r),
      static_cast<const float4*>(g), static_cast<const float4*>(b), rows,
      h / 4, r_rows, eps, static_cast<float4*>(y));
}

}  // namespace

// rows x h values, h % 4 == 0 and h <= 1024, every pointer on 16 bytes.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int cortex_add_layer_norm_launch(const void* x, const void* r,
                                            const void* g, const void* b,
                                            int64_t rows, int h,
                                            int64_t r_rows, float eps,
                                            void* y, void* stream) {
  if (rows <= 0) return 0;
  if (h <= 0 || h > 1024 || h % 4 != 0 || r_rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(blocks);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((h + 127) / 128) {
    case 1: launch_vec4<1>(x, r, g, b, rows, h, r_rows, eps, y, grid, st); break;
    case 2: launch_vec4<2>(x, r, g, b, rows, h, r_rows, eps, y, grid, st); break;
    case 3: launch_vec4<3>(x, r, g, b, rows, h, r_rows, eps, y, grid, st); break;
    case 4: launch_vec4<4>(x, r, g, b, rows, h, r_rows, eps, y, grid, st); break;
    case 5: launch_vec4<5>(x, r, g, b, rows, h, r_rows, eps, y, grid, st); break;
    case 6: launch_vec4<6>(x, r, g, b, rows, h, r_rows, eps, y, grid, st); break;
    case 7: launch_vec4<7>(x, r, g, b, rows, h, r_rows, eps, y, grid, st); break;
    default: launch_vec4<8>(x, r, g, b, rows, h, r_rows, eps, y, grid, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}
