// R1, retention eligibility (ops/decay.py), for sm_90a.
//
// Replaces the XLA program retention_eligibility
// (cortex_tpu/ops/decay.py:121-146): one elementwise pass over packed node
// arrays,
//     age      = (now - created_at) * (1 / 86400)
//     idle_d   = (now - last_accessed_at) * (1 / 86400)
//     expired  = ttl_days > 0 && age > ttl_days
//     idle     = idle_d > grace_days
//     unimport = min_score < 0 || score < min_score
//     out      = expired && idle && unimport && !(protect && has_inbound)
// over created_at, last_accessed_at, score f32 [N] and has_inbound bool [N],
// writing a bool [N] (one byte a node). Each of the five parameters (now,
// ttl_days, grace_days, min_score f32 and protect_inbound bool) is either
// one value for every node (stride 0) or one a node (stride 1): a sweep
// over several kinds passes per-node TTLs.
//
// XLA rewrites the division by the constant 86400 into a multiply by its
// float32 reciprocal, 1.15740741e-05; the true quotient differs from it in
// the last bit on some rows. The kernel multiplies, as XLA does, and spells
// it __fmul_rn(__fsub_rn(...)), so nvcc contracts nothing into an FMA: the
// mask equals the reference's bit for bit, and the plain torch version's
// (retention_eligibility_plain), which does one elementwise op at a time.
//
// What bounds it: bytes. A node reads 13 bytes (three f32 and a byte) and
// writes one, 14 B (140 MB at 10M nodes, 0.042 ms at 3.35 TB/s), more when
// parameters come a node each; its ten flops are far below what the card
// does while those bytes move.
//
// What the design does about it: one launch, each input read once and the
// output written once. A thread takes 4 nodes at a time, with one 16-byte
// load of each f32 array (and of each per-node f32 parameter), one 4-byte
// load of the bool arrays and one 4-byte store of the mask, in a grid-stride
// loop over a grid of a few blocks per SM; streaming loads and stores
// (__ldcs / __stcs), as nothing reads them again. Pointers that are not
// aligned for those widths, and the last N % 4 nodes, take the scalar path.
// The launch is checked with cudaGetLastError; nothing synchronises.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "device_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
// float32(1 / 86400) = 1.15740741e-05, the constant XLA multiplies by,
// spelled exactly
constexpr float kInvDay = 0x1.845c8ap-17f;

struct Params {
  const float* now;
  const float* ttl;
  const float* grace;
  const float* min_score;
  const uint8_t* protect;
  // 0: one value for every node, 1: one a node
  int now_s, ttl_s, grace_s, min_s, protect_s;
};

__device__ __forceinline__ uint8_t eligible_one(float created, float last,
                                                float score, uint8_t inbound,
                                                float now, float ttl,
                                                float grace, float min_score,
                                                uint8_t protect) {
  const float age = __fmul_rn(__fsub_rn(now, created), kInvDay);
  const float idle_d = __fmul_rn(__fsub_rn(now, last), kInvDay);
  const bool expired = ttl > 0.0f && age > ttl;
  const bool idle = idle_d > grace;
  const bool unimportant = min_score < 0.0f || score < min_score;
  const bool guarded = protect != 0 && inbound != 0;
  return expired && idle && unimportant && !guarded;
}

// four consecutive values of an f32 parameter from node 4 * i on
__device__ __forceinline__ float4 param4(const float* p, int stride,
                                         float scalar, int64_t i) {
  if (stride == 0) return make_float4(scalar, scalar, scalar, scalar);
  return __ldcs(reinterpret_cast<const float4*>(p) + i);
}

__device__ __forceinline__ uchar4 flag4(const uint8_t* p, int stride,
                                        uint8_t scalar, int64_t i) {
  if (stride == 0) return make_uchar4(scalar, scalar, scalar, scalar);
  return __ldcs(reinterpret_cast<const uchar4*>(p) + i);
}

__global__ void __launch_bounds__(kThreads)
    retention_kernel(const float* __restrict__ created,
                     const float* __restrict__ last,
                     const float* __restrict__ score,
                     const uint8_t* __restrict__ inbound, int64_t n, int vec4,
                     Params p, uint8_t* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  // the broadcast values, read once a thread
  const float now0 = p.now[0], ttl0 = p.ttl[0], grace0 = p.grace[0],
              min0 = p.min_score[0];
  const uint8_t prot0 = p.protect[0];
  int64_t tail = 0;
  if (vec4) {
    const int64_t n4 = n / 4;
    for (int64_t i = tid; i < n4; i += stride) {
      const float4 c = __ldcs(reinterpret_cast<const float4*>(created) + i);
      const float4 l = __ldcs(reinterpret_cast<const float4*>(last) + i);
      const float4 s = __ldcs(reinterpret_cast<const float4*>(score) + i);
      const uchar4 h = __ldcs(reinterpret_cast<const uchar4*>(inbound) + i);
      const float4 nw = param4(p.now, p.now_s, now0, i);
      const float4 tt = param4(p.ttl, p.ttl_s, ttl0, i);
      const float4 gr = param4(p.grace, p.grace_s, grace0, i);
      const float4 ms = param4(p.min_score, p.min_s, min0, i);
      const uchar4 pr = flag4(p.protect, p.protect_s, prot0, i);
      __stcs(reinterpret_cast<uchar4*>(out) + i,
             make_uchar4(
                 eligible_one(c.x, l.x, s.x, h.x, nw.x, tt.x, gr.x, ms.x, pr.x),
                 eligible_one(c.y, l.y, s.y, h.y, nw.y, tt.y, gr.y, ms.y, pr.y),
                 eligible_one(c.z, l.z, s.z, h.z, nw.z, tt.z, gr.z, ms.z, pr.z),
                 eligible_one(c.w, l.w, s.w, h.w, nw.w, tt.w, gr.w, ms.w,
                              pr.w)));
    }
    tail = n4 * 4;
  }
  for (int64_t i = tail + tid; i < n; i += stride) {
    out[i] = eligible_one(created[i], last[i], score[i], inbound[i],
                          p.now_s ? p.now[i] : now0,
                          p.ttl_s ? p.ttl[i] : ttl0,
                          p.grace_s ? p.grace[i] : grace0,
                          p.min_s ? p.min_score[i] : min0,
                          p.protect_s ? p.protect[i] : prot0);
  }
}

}  // namespace

extern "C" int cortex_retention_eligibility_launch(
    const void* created, const void* last, const void* score,
    const void* inbound, int64_t n, int vec4, const void* now, int now_s,
    const void* ttl, int ttl_s, const void* grace, int grace_s,
    const void* min_score, int min_s, const void* protect, int protect_s,
    void* out, void* stream) {
  if (n <= 0) return 0;
  cortex_dev::DeviceLimits lim;
  cudaError_t err = cortex_dev::device_limits(&lim);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t work = vec4 ? std::max<int64_t>(n / 4, n % 4) : n;
  const int64_t want = (work + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(
      std::min<int64_t>(want, int64_t{lim.sm_count} * kBlocksPerSm));
  const Params p{static_cast<const float*>(now),
                 static_cast<const float*>(ttl),
                 static_cast<const float*>(grace),
                 static_cast<const float*>(min_score),
                 static_cast<const uint8_t*>(protect),
                 now_s, ttl_s, grace_s, min_s, protect_s};
  retention_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(created), static_cast<const float*>(last),
      static_cast<const float*>(score), static_cast<const uint8_t*>(inbound),
      n, vec4, p, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
