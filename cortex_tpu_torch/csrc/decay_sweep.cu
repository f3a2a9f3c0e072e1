// D1, the edge decay sweep (ops/decay.py), for sm_90a.
//
// Replaces the XLA program decay_sweep (cortex_tpu/ops/decay.py:28): one
// elementwise pass over packed edge arrays,
//     eff    = daily_rate * (1 - max_importance * shield)
//     days   = max(days_since_update, 0)
//     new_w  = active ? weight * exp(-eff * days) : weight
//     active = !exempt && days > 0
//     delete = active && new_w < delete_threshold
//     prune  = active && new_w < prune_threshold && !delete
//     changed = active && new_w != weight
// over weight, days, max_importance f32 [E] and exempt bool [E], writing
// new_w f32 [E] and the three masks as bool [E] (one byte each, so the
// wrapper returns torch bools without a copy).
//
// What bounds it: bytes. An edge reads 13 bytes (three f32 and a byte)
// and writes 7 (an f32 and three bytes); its dozen flops and one expf are
// far below what the card does while those bytes move (20 B an edge:
// 200 MB at 10M edges, 0.060 ms at 3.35 TB/s).
//
// What the design does about it: one launch, each input read once and
// each output written once. A thread takes 4 edges at a time, with one
// 16-byte load of each f32 input, one 4-byte load of the exempt bytes,
// one 16-byte store of new_w and one 4-byte store of each mask, in a
// grid-stride loop over a grid of a few blocks per SM. Pointers that are
// not aligned for those widths, and the last E % 4 edges, take the scalar
// path. The arithmetic is spelled with __fmul_rn / __fsub_rn, so nvcc
// contracts nothing into an FMA, and expf (not __expf): the same
// operations, in the same order and rounding, as the plain torch version
// on the card (decay_sweep_plain), which does one elementwise op at a
// time. The launch is checked with cudaGetLastError; nothing
// synchronises.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "device_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

struct Params {
  float rate, shield, del_thr, prune_thr;
};

struct Out {
  float w;
  uint8_t del, prune, changed;
};

__device__ __forceinline__ Out sweep_one(float w, float days, float imp,
                                         uint8_t exempt, const Params& p) {
  const float eff = __fmul_rn(p.rate, __fsub_rn(1.0f, __fmul_rn(imp, p.shield)));
  const float d = fmaxf(days, 0.0f);
  const float decayed = __fmul_rn(w, expf(__fmul_rn(-eff, d)));
  const bool active = exempt == 0 && d > 0.0f;
  Out o;
  o.w = active ? decayed : w;
  const bool del = active && o.w < p.del_thr;
  o.del = del;
  o.prune = active && o.w < p.prune_thr && !del;
  o.changed = active && o.w != w;
  return o;
}

__global__ void __launch_bounds__(kThreads)
    decay_sweep_kernel(const float* __restrict__ w,
                       const float* __restrict__ days,
                       const float* __restrict__ imp,
                       const uint8_t* __restrict__ exempt, int64_t n,
                       int vec4, Params p, float* __restrict__ new_w,
                       uint8_t* __restrict__ del, uint8_t* __restrict__ prune,
                       uint8_t* __restrict__ changed) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  int64_t tail = 0;
  if (vec4) {
    const int64_t n4 = n / 4;
    for (int64_t i = tid; i < n4; i += stride) {
      const float4 wv = __ldcs(reinterpret_cast<const float4*>(w) + i);
      const float4 dv = __ldcs(reinterpret_cast<const float4*>(days) + i);
      const float4 mv = __ldcs(reinterpret_cast<const float4*>(imp) + i);
      const uchar4 ev = __ldcs(reinterpret_cast<const uchar4*>(exempt) + i);
      const Out a = sweep_one(wv.x, dv.x, mv.x, ev.x, p);
      const Out b = sweep_one(wv.y, dv.y, mv.y, ev.y, p);
      const Out c = sweep_one(wv.z, dv.z, mv.z, ev.z, p);
      const Out d = sweep_one(wv.w, dv.w, mv.w, ev.w, p);
      __stcs(reinterpret_cast<float4*>(new_w) + i,
             make_float4(a.w, b.w, c.w, d.w));
      __stcs(reinterpret_cast<uchar4*>(del) + i,
             make_uchar4(a.del, b.del, c.del, d.del));
      __stcs(reinterpret_cast<uchar4*>(prune) + i,
             make_uchar4(a.prune, b.prune, c.prune, d.prune));
      __stcs(reinterpret_cast<uchar4*>(changed) + i,
             make_uchar4(a.changed, b.changed, c.changed, d.changed));
    }
    tail = n4 * 4;
  }
  for (int64_t i = tail + tid; i < n; i += stride) {
    const Out o = sweep_one(w[i], days[i], imp[i], exempt[i], p);
    new_w[i] = o.w;
    del[i] = o.del;
    prune[i] = o.prune;
    changed[i] = o.changed;
  }
}

}  // namespace

extern "C" int cortex_decay_sweep_launch(
    const void* w, const void* days, const void* imp, const void* exempt,
    int64_t n, int vec4, float rate, float shield, float del_thr,
    float prune_thr, void* new_w, void* del, void* prune, void* changed,
    void* stream) {
  if (n <= 0) return 0;
  cortex_dev::DeviceLimits lim;
  cudaError_t err = cortex_dev::device_limits(&lim);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t work = vec4 ? std::max<int64_t>(n / 4, n % 4) : n;
  const int64_t want = (work + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(
      std::min<int64_t>(want, int64_t{lim.sm_count} * kBlocksPerSm));
  decay_sweep_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const float*>(days),
      static_cast<const float*>(imp), static_cast<const uint8_t*>(exempt), n,
      vec4, Params{rate, shield, del_thr, prune_thr},
      static_cast<float*>(new_w), static_cast<uint8_t*>(del),
      static_cast<uint8_t*>(prune), static_cast<uint8_t*>(changed));
  return static_cast<int>(cudaGetLastError());
}
