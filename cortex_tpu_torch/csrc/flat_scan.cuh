// The plain-C interface of the flat-index kernels (flat_scan.cu), shared
// by the op binding (flat_scan_op.cpp). No CUDA or PyTorch headers here.

#pragma once

#include <cstdint>

// K1's launch shape for one call, chosen by cortex_quant_scan_plan from
// the card, the shapes and cand; the binding allocates the partials
// [b, n_part * m], the zeroed keys the blocks share [n_groups * qt *
// (n_part + 1)] (u32) and, when bufs_global, the candidate buffers
// [n_groups * n_part * qt * capb] (vals f32 and rows i32).
struct QuantScanPlan {
  int qt;           // queries per block (16, 32, 48 or 64)
  int n_groups;     // ceil(b / qt): grid.y
  int n_part;       // row partitions, one persistent block each: grid.x
  int m;            // candidates each block keeps per query
  int capb;         // candidate buffer length per query (> m)
  int bufs_global;  // 1: the buffers live in device memory, not shared
  int smem;         // dynamic shared memory per block, bytes
  int aligned;      // 1: 16-byte cp.async row loads (d % 16 == 0)
};

extern "C" int cortex_quant_scan_plan(int b, int cap, int d, int cand,
                                      int aligned, QuantScanPlan* plan);
extern "C" int cortex_quant_scan_launch(
    const QuantScanPlan* plan, const void* emb, const void* rinv,
    const void* qi8, const void* qs, const void* bias, void* out_v,
    void* out_i, void* buf_v, void* buf_i, void* pub, int b, int cap, int d,
    int cand, void* stream);
extern "C" int cortex_quant_rerank_launch(
    const void* emb, const void* q, const void* cv, const void* ci,
    void* out_v, void* out_i, int b, int cap, int d, int cand, int cand_p2,
    int k, void* stream);
extern "C" const char* cortex_cuda_error_string(int err);
