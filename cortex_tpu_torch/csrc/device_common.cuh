// Device helpers shared by the port's int8 tensor-core kernels (K1 in
// flat_scan.cu, the IVF scan in ivf_gather.cu) and the host-side launch
// set-up every kernel of csrc/ shares. No PyTorch headers here.
//
// - cp.async (16 bytes, global -> shared), its commit and wait;
// - ldmatrix.x4 and mma.sync m16n8k32 s8 x s8 -> s32;
// - swz: the XOR swizzle of 16-byte chunks that keeps a tile of 128-byte
//   rows free of ldmatrix bank conflicts;
// - device_limits / fit_kernel: the card's SM count and opt-in shared
//   memory, and a kernel's blocks per SM, looked up once per device (a
//   kernel's dynamic shared memory limit is raised once per device, not
//   on every launch).

#pragma once

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <mutex>
#include <utility>
#include <vector>

#include <cuda_runtime.h>

namespace cortex_dev {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c += a (16 x 32 s8, row) * b (32 x 8 s8, col), s32 accumulate
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// byte offset of the 16-byte chunk `c` (of 128-byte slices) of row `r`
// in a tile whose rows are `stride` bytes: chunks XOR-swizzled by r % 8
__device__ __forceinline__ int swz(int r, int c, int stride) {
  return r * stride + ((c & ~7) << 4) + (((c & 7) ^ (r & 7)) << 4);
}

struct DeviceLimits {
  int dev;
  int sm_count;
  int smem_optin;      // shared memory a block may opt into
};

// The current device's limits, read from the runtime once per device.
inline cudaError_t device_limits(DeviceLimits* out) {
  static std::mutex mu;
  static std::vector<DeviceLimits> known;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> lock(mu);
  for (const DeviceLimits& k : known) {
    if (k.dev == dev) {
      *out = k;
      return cudaSuccess;
    }
  }
  DeviceLimits k{dev, 0, 0};
  err = cudaDeviceGetAttribute(&k.sm_count, cudaDevAttrMultiProcessorCount,
                               dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&k.smem_optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return err;
  known.push_back(k);
  *out = k;
  return cudaSuccess;
}

// Blocks of `kernel` (`threads` threads, `smem` bytes of dynamic shared
// memory) that fit on one SM of the current device, with that device's
// limits. The first call per (kernel, device) raises the kernel's dynamic
// shared memory limit to what the device's opt-in maximum leaves beside
// the kernel's static shared memory; answers are cached
// per (kernel, device, threads, smem). Returns cudaErrorInvalidValue when
// smem and the kernel's static shared memory exceed the opt-in maximum.
inline cudaError_t fit_kernel(const void* kernel, int threads, size_t smem,
                              DeviceLimits* lim, int* per_sm) {
  struct Fit {
    const void* kernel;
    int dev, threads;
    size_t smem;
    int per_sm;
  };
  static std::mutex mu;
  static std::vector<Fit> fits;
  static std::vector<std::pair<const void*, int>> raised;
  cudaError_t err = device_limits(lim);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> lock(mu);
  for (const Fit& f : fits) {
    if (f.kernel == kernel && f.dev == lim->dev && f.threads == threads &&
        f.smem == smem) {
      *per_sm = f.per_sm;
      return cudaSuccess;
    }
  }
  // the opt-in maximum covers static and dynamic shared memory together
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  const size_t dyn_max = static_cast<size_t>(lim->smem_optin) -
                         std::min(attr.sharedSizeBytes,
                                  static_cast<size_t>(lim->smem_optin));
  if (smem > dyn_max) return cudaErrorInvalidValue;
  bool is_raised = false;
  for (const auto& r : raised) {
    is_raised |= r.first == kernel && r.second == lim->dev;
  }
  if (!is_raised) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dyn_max));
    if (err != cudaSuccess) return err;
    raised.emplace_back(kernel, lim->dev);
  }
  int n = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                      smem);
  if (err != cudaSuccess) return err;
  fits.push_back(Fit{kernel, lim->dev, threads, smem, n});
  *per_sm = n;
  return cudaSuccess;
}

}  // namespace cortex_dev
