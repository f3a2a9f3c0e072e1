#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cortex_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py              # the phases below
    python3 chip_smoke.py --profile    # phases 3 and 5's indexes, layers

Phases, each printing its results on its own line:

  1. build the CUDA kernels (every source of csrc/, one library in
     cortex_tpu_torch/_build/), name the card and say whether the
     native host re-rank (cortex_tpu_torch/native/) built and loaded;
  2. hold each kernel against its plain torch version. probed_scores
     (IVF): a small odd shape, the 384-d shape of phase 4's layout and
     the 1M x 768 layout of phase 3 over 64 queries; unfiltered,
     filtered and host-bias, and at the 1M layout also skewed probes (64
     copies of one query) and repeated and invalid probe ids; scores and
     rows equal exactly on unmasked entries, with equal masks and equal
     empty slots (row -1). quant_candidates (K1) and quant_rerank
     (K2, flat): a small odd shape, the 384-d shape of phase 6 and the
     1M x 768 planes of phase 5 over 64 queries, cand 64 and 2048,
     unfiltered, filtered and host-bias; K1's returned scores bit-equal
     to the plain scores of their rows, its cand-th value equal, its row
     sets equal but for exact ties at the boundary; K2's scores within
     SCORE_ATOL, ids equal but for near-ties of NEAR_TIE. Then each
     kernel's and its plain version's times (CUDA events) at the 1M
     shapes at batch 64 and at batch 1 (K1 also at cand 2048, beside
     torch._int_mm computing its int8 product alone, "product only"),
     each beside its bound: the least time the card could take, the
     larger of the bytes the function must move over 3.35 TB/s and its
     operations over the peak for their type (int8 1,979 TOP/s, fp32
     67 TFLOP/s; NVIDIA's H100 SXM data sheet), and its share of the
     bound (bound / time); probed_scores' bytes count the distinct lists
     the queries probe (printed with the mean queries per probed list),
     and it too is timed beside torch._int_mm's product alone over the
     same rows. The graph mirror's kernels, frontier_bfs and
     frontier_bfs_compact (G1, one walk kernel) and bfs_relax (G2):
     small odd tables with duplicate, -1 and isolated anchors, caps that
     overflow and caps that do not, widths that fill, 0 to 8 hops, and a
     10,000,000 x 64 table (~10 neighbours a row, 0.1 % hubs full to the
     width, the 100M-edge tier's shape) with 1 and 8 anchors: the
     walks' overflow flags always equal to the plain versions', G1's
     depths and the compact walk's reached count and (row, depth) pairs
     equal whenever the flag is false, its scratch left all INF_DEPTH;
     G2's depths equal, also at partial tiles of 8 anchors; then each
     kernel's and plain version's times at that table beside their
     bounds in bytes (G1: the frontier slots and rows it reads, a dist
     entry a pair, the next frontier, then dist written once or the
     compact walk's reached pairs; G2: the table and dist in and out, a
     round, not counting its gathers). The walks are timed through the
     wrapper from host anchors, as the mirror calls them (ms), and
     through the op alone (op_ms);
  3. the IVF index at 1,000,000 x 768 (seeded clustered unit rows): at
     nprobe = nlist the top-10 of 64 queries equals the exact fp32
     oracle (near-ties of 1e-6 may swap); at the default nprobe the
     recall@10, batch-64 throughput (median of 5 runs of 30 batches) and
     batch-1 latency (p50 and p99 over 1,000 queries); then 1,000
     inserts and 100 removes through the incremental update;
  4. the Cortex slice: Cortex.open on SQLite with index = "ivf" (every
     list probed), store_batch 20,000 seeded nodes, store / delete_node,
     searches with decay and record_access, a kind filter and > 64
     exclusions; the same searches at the default nprobe against the
     exact results; close, reopen (rebuild from storage), the same
     results;
  5. the flat index (the default) over phase 3's rows: it resolves to
     the quant path (K1 + K2); search_path "exact" equals the oracle,
     "auto" reaches recall@10 >= 0.99 with every score exact; the same
     speed measures as phase 3; 1,000 inserts and 100 removes in place;
  6. Cortex with CortexConfig() unchanged (flat, float32, auto) on
     SQLite and 20,000 nodes: own text first, a kind filter, > 64
     exclusions, results equal to the exact path's, the same after a
     reopen;
  7. hybrid search at BASELINE config #4 on phase 5's flat index: 1M
     light nodes in a MemoryStorage, ~5M seeded edges (mostly within a
     row's cluster, Pareto-tailed degree up to the table's 64) in the
     packed snapshot (from the seeded arrays through PackedAdjacency's
     constructor, held against PackedAdjacency.build on a 20,000-row
     subset), limit 17 (a 51-hit vector leg), 2-hop anchors; no anchors,
     anchors, a kind filter and an edge-less anchor, each against a
     numpy oracle (exact fp32 scores of the vector leg's hits fused with
     multi_bfs depths); every anchor through the compact walk
     (HOST_FRONTIER_BUDGET = 0) with the host tier's results, and both
     walks against their plain versions on the snapshot's table at each
     query's anchors (the compact one on the mirror's scratch); batch-1
     latency
     (p50, p99) of both tiers, split into vector leg, proximity leg and
     fusion;
  8. Cortex with edges on phase 6's store: 10,000 seeded create_edge
     calls, search_hybrid against the same oracle (depths from a plain
     BFS), traverse / neighborhood / find_paths against a host BFS, G2
     through per_anchor (HOST_FRONTIER_BUDGET = 0) and G1 then G2
     through depths_from (the frontier cap forced to overflow) with the
     host tier's results, G1 and G2 against their plain versions on
     the mirror's table, delete_edge, and the same after a reopen.

Three main paths: phases 3-4 (IVF), 5-6 (flat) and 7-8 (graph, on the
flat index). Every launch count is set to 0 just before each and read
just after it: probed_scores from the first, quant_candidates and
quant_rerank from the second and third, frontier_bfs,
frontier_bfs_compact and bfs_relax from the third; launches made in
phase 2, or to compare a kernel with
its plain version in phases 7-8, do not count. The line before the last lists the
kernels as JSON, the line before that the card's name and power limit;
the last line is the device JSON. At the end the script fails if any
module of the JAX package (cortex_tpu or cortex_tpu.*) was imported:
the port and this script import none. Any failed check raises, so the
script exits non-zero; so it does without CUDA or without the
cortex_tpu_torch package beside it.

--profile builds the kernels, phase 3's and phase 5's indexes, measures
each one's search speed as phases 3 and 5 do, then traces
PROFILE_ROUNDS searches at batch 64 and at batch 1 with torch.profiler:
host ms per search in each layer's span, device ms per kernel, and the
device's idle share of the traced wall. The Chrome traces go to
profile_out/ beside this script. Last, on the flat index's planes, it
times K1's kernel whole and cut short after each of its parts, and K2
with its largest warp sort of 64, 256 and 1,024 entries, each from
csrc/flat_scan.cu built alone with a compile-time switch
(CORTEX_K1_PARTS, CORTEX_K2_WARP_SORT_MAX). Then it traces
PROFILE_ROUNDS hybrid searches of phase 7's device tier (host ms per
leg, device ms per kernel, idle share), and times G2 from
csrc/graph_bfs.cu built alone, whole and cut after its table read
(CORTEX_RELAX_PARTS).
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np

D_BIG, N_BIG, BATCH, K = 768, 1_000_000, 64, 10
N_NODES, DIM_NODES = 20_000, 384
QPS_RUNS, QPS_ROUNDS, N_LAT = 5, 30, 1000
PROFILE_ROUNDS = 20
HBM_BYTES_PER_S = 3.35e12       # H100 SXM peaks, NVIDIA's data sheet
INT8_OPS_PER_S = 1.979e15       # dense int8 tensor cores
F32_OPS_PER_S = 67e12           # fp32 outside the tensor cores
SPIN_CYCLES_PER_S = 2e9         # >= the SM clock (1.98 GHz at boost)
NEAR_TIE = 1e-6          # exact-oracle near-ties that may swap ranks
SCORE_ATOL = 1e-5        # fp32 scores: host re-rank vs device oracle
FLAT_CANDS = (64, 2048)   # k = 10 (k bucket 16) and search_threshold's 1000
GRAPH_ROWS, GRAPH_DEG = 10_000_000, 64   # the 100M-edge tier's table
GRAPH_MEAN_DEG, GRAPH_HUBS = 9.0, 0.001  # ~10 neighbours a row, 0.1 % hubs
GRAPH_CAP, GRAPH_OUT_CAP = 8192, 16384   # DEVICE_FRONTIER_CAP, PACKED_OUT_CAP
HYB_EDGES, HYB_LIMIT, HYB_HOPS = 5_000_000, 17, 2    # BASELINE config #4
HYB_QUERIES, HYB_LAT = 48, 300
CX_EDGES = 10_000
KERNELS = {               # name -> (source, what it replaces)
    "probed_scores": ("cortex_tpu_torch/csrc/ivf_gather.cu",
                      "cortex_tpu/ops/ivf_gather.py:114"),
    "quant_candidates": ("cortex_tpu_torch/csrc/flat_scan.cu",
                         "cortex_tpu/ops/similarity.py:167"),
    "quant_rerank": ("cortex_tpu_torch/csrc/flat_scan.cu",
                     "cortex_tpu/ops/similarity.py:239"),
    "frontier_bfs": ("cortex_tpu_torch/csrc/graph_bfs.cu",
                     "cortex_tpu/graph/csr.py:70"),
    "frontier_bfs_compact": ("cortex_tpu_torch/csrc/graph_bfs.cu",
                             "cortex_tpu/graph/csr.py:120"),
    "bfs_relax": ("cortex_tpu_torch/csrc/graph_bfs.cu",
                  "cortex_tpu/graph/csr.py:47"),
}


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def say(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def _wrappers():
    from cortex_tpu_torch.ops import graph_bfs, ivf_gather, similarity
    return {"probed_scores": ivf_gather.probed_scores,
            "quant_candidates": similarity.quant_candidates,
            "quant_rerank": similarity.quant_rerank,
            "frontier_bfs": graph_bfs.frontier_bfs,
            "frontier_bfs_compact": graph_bfs.frontier_bfs_compact,
            "bfs_relax": graph_bfs.bfs_relax}


def reset_launches(names=None):
    for name, fn in _wrappers().items():
        if names is None or name in names:
            fn.launches = 0


def launch_counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


@contextlib.contextmanager
def uncounted():
    """Launches inside compare a kernel with its plain version on the
    main path's inputs: they are not the main path's, so every count is
    put back afterwards."""
    before = launch_counts()
    try:
        yield
    finally:
        for name, fn in _wrappers().items():
            fn.launches = before[name]


# ------------------------------------------------------------ phase 2


class KernelCheck:
    """Kernel vs plain comparisons; keeps the largest difference seen
    on unmasked entries (must stay 0.0)."""

    def __init__(self):
        self.max_abs_err = 0.0
        self.cases = 0

    def compare(self, args, *, filtered, host_bias=None):
        import torch
        from cortex_tpu_torch.ops.ivf_gather import (probed_scores,
                                                     probed_scores_plain)
        from cortex_tpu_torch.vector.ivf import apply_host_bias
        got = probed_scores(*args, filtered=filtered)
        want = probed_scores_plain(*args, filtered=filtered)
        if host_bias is not None:
            got = (apply_host_bias(got[0], got[1], host_bias), got[1])
            want = (apply_host_bias(want[0], want[1], host_bias), want[1])
        torch.cuda.synchronize()
        (s1, r1), (s2, r2) = got, want
        check(torch.equal(r1 == -1, r2 == -1), "kernel and plain empty "
              "slots differ")
        m1, m2 = s1 > -1e29, s2 > -1e29
        check(torch.equal(m1, m2), "kernel and plain masks differ")
        check(bool(m1.any()), "comparison saw no unmasked entry")
        err = float((s1[m1] - s2[m2]).abs().max())
        check(err == 0.0, f"kernel scores differ from plain by {err}")
        check(torch.equal(r1[m1], r2[m2]), "kernel rows differ from plain")
        self.max_abs_err = max(self.max_abs_err, err)
        self.cases += 1


def synthetic_layout(dev, gen, c, l, d):
    """Random int8 layout with empty slots, kind/agent codes, rinv."""
    import torch
    emb = torch.randint(-127, 128, (c, l, d), dtype=torch.int8,
                        device=dev, generator=gen)
    rows = torch.randperm(c * l, device=dev, generator=gen
                          ).to(torch.int32).reshape(c, l)
    empty = torch.rand((c, l), device=dev, generator=gen) < 0.2
    rows[empty] = -1
    emb[empty] = 0
    kinds = torch.randint(0, 5, (c, l), dtype=torch.int32, device=dev,
                          generator=gen)
    agents = torch.randint(0, 3, (c, l), dtype=torch.int32, device=dev,
                           generator=gen)
    kinds[empty] = -2
    agents[empty] = -2
    rinv = torch.rand((c, l), device=dev, generator=gen) * 0.01 + 0.001
    return emb, rinv, rows, kinds, agents


def filter_lists(dev, rows, *, on, agent=1):
    """(ak, aa, ex): all NO_FILTER, or kinds {1, 3} + one agent code +
    the first 40 live rows excluded."""
    import torch
    ak = torch.full((16,), -2, dtype=torch.int32, device=dev)
    aa = torch.full((1,), -1, dtype=torch.int32, device=dev)
    ex = torch.full((64,), -1, dtype=torch.int32, device=dev)
    if on:
        ak[0], ak[1] = 1, 3
        aa[0] = agent
        live = rows.reshape(-1)
        live = live[live >= 0][:40]
        ex[:len(live)] = live
    else:
        ak[0] = -1
    return ak, aa, ex


def check_synthetic(kc, dev, gen, c, l, d, b, p):
    import torch
    layout = synthetic_layout(dev, gen, c, l, d)
    probe = torch.randint(0, c, (b, p), dtype=torch.int32, device=dev,
                          generator=gen)
    qi8 = torch.randint(-127, 128, (b, d), dtype=torch.int8, device=dev,
                        generator=gen)
    for on in (False, True):
        kc.compare((*layout, probe, qi8, *filter_lists(dev, layout[2],
                                                       on=on)),
                   filtered=on)
    bias = torch.where(torch.rand(c * l, device=dev, generator=gen) < 0.3,
                       -1e30, 0.0).to(torch.float32)
    kc.compare((*layout, probe, qi8, *filter_lists(dev, layout[2],
                                                   on=False)),
               filtered=False, host_bias=bias)


def time_ms(fn, reps):
    """Device time per call from CUDA events around `reps` calls, after
    two warm-up calls. A spin kernel (torch.cuda._sleep) holds the device
    while the calls are enqueued, longer than one call's host and device
    time each, so that the calls run back to back and the events time
    the device, not the host's enqueueing (which exceeds a short
    kernel's time)."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    hold_s = min(2.0, 2 * reps * (time.perf_counter() - t0) + 1e-3)
    torch.cuda._sleep(int(hold_s * SPIN_CYCLES_PER_S))
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def bound_ms(nbytes, ops, peak):
    """(ms, "bytes" or "operations"): the least time the card could
    take for a function that moves nbytes (each input read once, each
    output written once) and does ops operations of a type whose peak
    rate is `peak`."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def timing(kernel_ms, plain_ms, bound, **extra):
    """One measured shape: the kernel's and plain version's times, the
    bound and the kernel's share of it."""
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "share_of_bound": bound[0] / kernel_ms,
            **extra}


def check_real_layout(kc, index, queries):
    """Phase 2 at the 1M layout: the probes and int8 queries of a real
    default-nprobe search; returns the timings at batch 64 and 1."""
    import torch
    from cortex_tpu_torch.ops.ivf_gather import (probed_scores,
                                                 probed_scores_plain)
    from cortex_tpu_torch.ops.similarity import quantize_queries
    co = index._corpus
    cent, emb, rinv, rows, kinds, agents = co._ivf_dev
    dev = emb.device
    q = torch.from_numpy(queries).to(dev)
    p = co._nprobe(cent.shape[0])
    probe = torch.topk(q @ cent.T, p, dim=1).indices.to(torch.int32)
    qi8, _ = quantize_queries(q)
    off = filter_lists(dev, rows, on=False)
    args = (emb, rinv, rows, kinds, agents, probe, qi8, *off)
    kc.compare(args, filtered=False)
    kc.compare((emb, rinv, rows, kinds, agents, probe, qi8,
                *filter_lists(dev, rows, on=True, agent=0)), filtered=True)
    bias = torch.from_numpy(co._host_bias(["k1"], None, None)).to(dev)
    kc.compare(args, filtered=False, host_bias=bias)
    # skewed: 64 copies of one query, so each of its lists is probed 64
    # times; repeats: each query probes lists twice, plus invalid ids
    skew = (emb, rinv, rows, kinds, agents, probe[:1].expand_as(probe)
            .contiguous(), qi8[:1].expand_as(qi8).contiguous())
    kc.compare((*skew, *off), filtered=False)
    kc.compare((*skew, *filter_lists(dev, rows, on=True, agent=0)),
               filtered=True)
    rep = probe.clone()
    rep[:, 1::2] = rep[:, 0::2][:, :p // 2]
    rep[::5, 3] = cent.shape[0]
    rep[1::5, 7] = -1
    kc.compare((emb, rinv, rows, kinds, agents, rep, qi8, *off),
               filtered=False)
    out = {}
    c, l, d = emb.shape
    for b in (BATCH, 1):
        a = (emb, rinv, rows, kinds, agents, probe[:b], qi8[:b], *off)
        lists = int(torch.unique(probe[:b]).numel())
        # unfiltered, a slot's bytes are its row, rinv and slot_rows
        nbytes = (lists * l * (d + 8) + b * d + 4 * b * p + 8 * b * p * l)
        # the int8 product alone over the same rows ("product only": not
        # the same function): at batch 64 every list (the batch probes
        # them all), at batch 1 the first 128 lists, against the query
        # padded to 32 rows (cuBLASLt's shape rule)
        qp = torch.nn.functional.pad(qi8[:b], (0, 0, 0, max(0, 32 - b)))
        rows_mm = (emb.reshape(c * l, d) if b > 1
                   else emb[:p].reshape(p * l, d))
        out[f"b{b}"] = timing(
            time_ms(lambda: probed_scores(*a, filtered=False), 20),
            time_ms(lambda: probed_scores_plain(*a, filtered=False), 3),
            bound_ms(nbytes, 2 * b * p * l * d, INT8_OPS_PER_S),
            lists_probed=lists, queries_per_probed_list=b * p / lists,
            int_mm_product_only_ms=time_ms(
                lambda: torch._int_mm(qp, rows_mm.T), 5))
    return out, p


# ------------------------------------------------ phase 2, flat kernels


class FlatKernelCheck:
    """K1 and K2 against their plain versions. K1: every returned row's
    score bit-equal to the plain score of that row, the cand-th value
    equal, the row sets equal except for exact ties at the boundary
    (max_abs_err must stay 0.0). K2: scores within SCORE_ATOL (f32
    summation order), ids equal except at near-ties of NEAR_TIE."""

    def __init__(self):
        self.k1_err = 0.0
        self.k2_err = 0.0
        self.cases = 0

    def k1(self, emb_i8, rinv, qi8, qs, bias, cand):
        import torch
        from cortex_tpu_torch.ops import similarity as sim
        v, i = sim.quant_candidates(emb_i8, rinv, qi8, qs, bias, cand)
        pv, pi = sim.quant_candidates_plain(emb_i8, rinv, qi8, qs, bias,
                                            cand)
        full = sim.int8_dot(qi8, emb_i8) * (rinv[None, :] / qs[:, None])
        full = full + bias[None, :]
        torch.cuda.synchronize()
        kk = min(cand, emb_i8.shape[0])
        mine = torch.gather(full, 1, i[:, :kk].long())
        err = float((v[:, :kk] - mine).abs().max())
        check(torch.equal(v[:, :kk], mine),
              f"K1 scores differ from the plain scores of their rows ({err})")
        check(torch.equal(v[:, kk - 1], pv[:, kk - 1]),
              "K1's cand-th value differs from plain")
        edge = pv[:, kk - 1].cpu().numpy()
        ih, ph, fh = i[:, :kk].cpu().numpy(), pi[:, :kk].cpu().numpy(), None
        for b in range(ih.shape[0]):
            diff = set(ih[b].tolist()) ^ set(ph[b].tolist())
            if diff:
                if fh is None:
                    fh = full.cpu().numpy()
                check(all(fh[b, r] == edge[b] for r in diff),
                      "K1 row set differs from plain beyond a boundary tie")
        self.k1_err = max(self.k1_err, err)
        self.cases += 1
        return v, i

    def k2(self, emb, q, cv, ci, k):
        import torch
        from cortex_tpu_torch.ops import similarity as sim
        v, i = sim.quant_rerank(emb, q, cv, ci, k)
        pv, pi = sim.quant_rerank_plain(emb, q, cv, ci, k)
        torch.cuda.synchronize()
        live = pv > -1e29
        check(torch.equal(v > -1e29, live), "K2 masks differ from plain")
        err = float((v - pv)[live].abs().max()) if bool(live.any()) else 0.0
        check(err <= SCORE_ATOL, f"K2 scores differ from plain by {err}")
        vh, ih, ph = pv.cpu().numpy(), i.cpu().numpy(), pi.cpu().numpy()
        for b, j in zip(*np.nonzero(ih != ph)):
            near = [abs(vh[b, j] - vh[b, t]) for t in (j - 1, j + 1)
                    if 0 <= t < vh.shape[1]]
            check(min(near) <= NEAR_TIE, "K2 ids differ beyond a near-tie")
        self.k2_err = max(self.k2_err, err)
        self.cases += 1


def check_flat_synthetic(fc, dev, gen, cap, d, b):
    """K1 (cand 64, 2048) and K2 on random int8 / f32 planes: unfiltered,
    filtered (build_bias) and host bias."""
    import torch
    from cortex_tpu_torch.ops.similarity import quantize_queries
    emb_i8 = torch.randint(-127, 128, (cap, d), dtype=torch.int8,
                           device=dev, generator=gen)
    rinv = torch.rand(cap, device=dev, generator=gen) * 0.01 + 0.001
    emb = torch.randn((cap, d), device=dev, generator=gen)
    emb /= emb.norm(dim=1, keepdim=True)
    q = torch.randn((b, d), device=dev, generator=gen)
    q /= q.norm(dim=1, keepdim=True)
    qi8, qs = quantize_queries(q)
    live = torch.rand(cap, device=dev, generator=gen) < 0.9
    kinds = torch.randint(0, 5, (cap,), dtype=torch.int32, device=dev,
                          generator=gen)
    agents = torch.randint(0, 3, (cap,), dtype=torch.int32, device=dev,
                           generator=gen)
    for bias in flat_biases(live, kinds, agents, gen):
        for cand in FLAT_CANDS:
            cv, ci = fc.k1(emb_i8, rinv, qi8, qs, bias, cand)
            fc.k2(emb, q, cv, ci, 16)


def flat_biases(live, kinds, agents, gen, host=None, agent=1):
    """Unfiltered, filtered (kinds {1, 3}, agent code `agent`, 40
    exclusions) and host (given, or 30 % of the rows masked) biases."""
    import torch
    from cortex_tpu_torch.vector.shard import build_bias
    off = np.full(16, -2, np.int32)
    off[0] = -1
    ak = np.full(16, -2, np.int32)
    ak[:2] = (1, 3)
    ex = np.full(64, -1, np.int32)
    ex[:40] = np.arange(40)
    if host is None:
        host = torch.where(torch.rand(live.shape[0], device=live.device,
                                      generator=gen) < 0.3, -1e30, 0.0)
    return (build_bias(live, kinds, agents, off, np.int32(-1),
                       np.full(64, -1, np.int32)),
            build_bias(live, kinds, agents, ak, np.int32(agent), ex),
            host.to(torch.float32))


# ------------------------------------------------------------ phase 3


def clustered_rows(gen, dev, n, d, *, groups, spread=0.35,
                   with_member=False):
    """Seeded clustered unit rows on the device: `groups` random centers
    and n members, center + spread * noise (unit-scale vectors); with
    the rows' cluster numbers (a host array) when with_member."""
    import torch
    centers = torch.randn((groups, d), device=dev, generator=gen)
    centers /= centers.norm(dim=1, keepdim=True)
    member = torch.randint(0, groups, (n,), device=dev, generator=gen)
    x = centers[member] + spread * torch.randn(
        (n, d), device=dev, generator=gen) / d ** 0.5
    x = x / x.norm(dim=1, keepdim=True)
    if with_member:
        return x, centers, member.cpu().numpy()
    return x, centers


def noisy_centers(gen, centers, n):
    """n unit queries, each a noisy copy of a random cluster center."""
    import torch
    d = centers.shape[1]
    sel = torch.randint(0, centers.shape[0], (n,), device=centers.device,
                        generator=gen)
    q = centers[sel] + 0.35 * torch.randn((n, d), device=centers.device,
                                          generator=gen) / d ** 0.5
    return (q / q.norm(dim=1, keepdim=True)).cpu().numpy()


def oracle_topk(corpus_h, live_h, q_np, k, dev):
    """Exact fp32 top-k over the index's host mirror: chunked
    torch.matmul on the card (TF32 off)."""
    import torch
    q = torch.from_numpy(q_np).to(dev)
    best_v, best_i = None, None
    step = 1 << 18
    for s in range(0, corpus_h.shape[0], step):
        blk = torch.from_numpy(corpus_h[s:s + step]).to(dev)
        sc = q @ blk.T
        live = torch.from_numpy(live_h[s:s + step]).to(dev)
        sc = torch.where(live[None, :], sc, torch.full_like(sc, -3.0))
        v, i = torch.topk(sc, k + 1, dim=1)
        i = i + s
        if best_v is not None:
            v = torch.cat([best_v, v], 1)
            i = torch.cat([best_i, i], 1)
            v, sel = torch.topk(v, k + 1, dim=1)
            i = torch.gather(i, 1, sel)
        best_v, best_i = v, i
    return best_v.cpu().numpy(), best_i.cpu().numpy()


def hits_match_oracle(hits, ov, oi, id_of, k):
    """The index's top-k equals the oracle's, except that ranks whose
    oracle scores lie within NEAR_TIE of each other may swap."""
    got = [i for i, _ in hits]
    want = [id_of[r] for r in oi[:k]]
    check(len(got) == k, f"expected {k} hits, got {len(got)}")
    for j, (g, w) in enumerate(zip(got, want)):
        if g != w:
            check(abs(ov[j] - ov[min(j + 1, k)]) <= NEAR_TIE
                  or abs(ov[j] - ov[max(j - 1, 0)]) <= NEAR_TIE,
                  f"rank {j}: {g} != oracle {w} (no near-tie)")
    np.testing.assert_allclose([s for _, s in hits], ov[:k],
                               atol=SCORE_ATOL)


def phase_index(dev, n, d, gen, kc):
    """Phases 3 (build) and 2 at the real layout; returns the index, the
    query sets, the timings and the rows (for phase 5)."""
    import torch
    from cortex_tpu_torch.vector.ivf import TorchIvfIndex
    t0 = time.monotonic()
    x, centers, member = clustered_rows(gen, dev, n, d,
                                        groups=max(1, n // 50),
                                        with_member=True)
    x_h = x.cpu().numpy()
    del x
    kinds = [f"k{i % 4}" for i in range(n)]
    ids = [f"r{i}" for i in range(n)]
    t_gen = time.monotonic() - t0
    index = TorchIvfIndex(d, device=dev)
    t0 = time.monotonic()
    index.insert_batch(ids, x_h, kinds=kinds)
    t_insert = time.monotonic() - t0
    t0 = time.monotonic()
    index._corpus.sync()                       # k-means + pack + upload
    torch.cuda.synchronize()
    t_build = time.monotonic() - t0
    co = index._corpus
    c, l, _ = co._ivf_dev[1].shape
    say("3-build", rows=n, dim=d, nlist=int(c), slots_per_list=int(l),
        nprobe=int(co._nprobe(c)), spill=bool(co._has_spill),
        gen_s=round(t_gen, 2), insert_s=round(t_insert, 2),
        build_s=round(t_build, 2))
    q_np = noisy_centers(gen, centers, BATCH)
    q_lat = noisy_centers(gen, centers, N_LAT)
    perf, p = check_real_layout(kc, index, q_np)
    say("2-kernel-1M", nprobe=int(p), cases=kc.cases,
        max_abs_err=kc.max_abs_err, **perf)
    return index, q_np, q_lat, perf, (x_h, ids, kinds, q_np, member)


def search_speed(index, q_np, q_lat):
    """Batch-64 queries/s (median of QPS_RUNS runs of QPS_ROUNDS
    batches) and batch-1 latency in ms (p50, p99 over len(q_lat)
    queries), on the host clock around search_batch with k = K, after
    one untimed search of each shape (the first search loads the host
    re-rank library)."""
    index.search_batch(q_np, K)
    index.search_batch(q_lat[:1], K)
    qps = []
    for _ in range(QPS_RUNS):
        t0 = time.perf_counter()
        for _ in range(QPS_ROUNDS):
            index.search_batch(q_np, K)
        qps.append(QPS_ROUNDS * len(q_np) / (time.perf_counter() - t0))
    lat = []
    for b in range(len(q_lat)):
        t0 = time.perf_counter()
        index.search_batch(q_lat[b:b + 1], K)
        lat.append((time.perf_counter() - t0) * 1e3)
    p50, p99 = np.percentile(lat, [50, 99])
    return qps, float(p50), float(p99)


def phase_search(index, q_np, q_lat, gen, dev, card):
    """Phase 3 searches: full-probe exactness, default-nprobe recall,
    throughput and latency, then incremental inserts and removes."""
    import torch
    co = index._corpus
    c = co._ivf_dev[0].shape[0]
    ov, oi = oracle_topk(co._emb_h, co._live_h, q_np, K, dev)
    default_p = co._nprobe_cfg
    co._nprobe_cfg = c                         # nprobe = nlist
    full = index.search_batch(q_np, K)
    co._nprobe_cfg = default_p
    for b in range(BATCH):
        hits_match_oracle(full[b], ov[b], oi[b], co._id_of, K)
    hits = index.search_batch(q_np, K)
    truth = [{co._id_of[r] for r in oi[b][:K]} for b in range(BATCH)]
    recall = float(np.mean([len({i for i, _ in h} & t) / K
                            for h, t in zip(hits, truth)]))
    qps, p50, p99 = search_speed(index, q_np, q_lat)
    say("3-search", full_probe_exact=True, nprobe=int(co._nprobe(c)),
        recall_at_10=recall, batch64_qps_median=statistics.median(qps),
        batch64_qps_runs=qps, batch1_ms_p50=p50, batch1_ms_p99=p99,
        batch1_queries=len(q_lat), card=card)
    check(recall >= 0.9, f"default-nprobe recall@10 {recall} < 0.9")
    # incremental: 1,000 fresh rows, 100 removes
    new, _ = clustered_rows(gen, dev, 1000, q_np.shape[1], groups=1000,
                            spread=0.5)
    new_h = new.cpu().numpy()
    new_ids = [f"new{i}" for i in range(len(new_h))]
    step = max(1, len(index) // 100)
    gone = [f"r{i}" for i in range(0, len(index), step)][:100]
    gone_vecs = co._emb_h[[co._row_of[i] for i in gone]].copy()
    index.insert_batch(new_ids, new_h, kinds=["k9"] * len(new_ids))
    for i in gone:
        check(index.remove(i), f"remove({i}) failed")
    trained_before = co._trained_live
    top = index.search_batch(new_h, 1)
    check(co._trained_live == trained_before,
          "1,000 inserts triggered a full rebuild")
    missed = [i for i, h in zip(new_ids, top) if not h or h[0][0] != i]
    check(not missed, f"{len(missed)} inserted rows are not their own "
          f"top-1, e.g. {missed[:3]}")
    found = {i for h in index.search_batch(gone_vecs, K) for i, _ in h}
    check(not found & set(gone), "a removed row was returned")
    say("3-update", inserted=len(new_ids), removed=len(gone),
        self_top1=True, removed_never_returned=True)


# ------------------------------------------------------------ phase 4


def seeded_nodes(n, seed, *, topics=400):
    """Seeded nodes of mixed kinds and agents whose texts cluster by
    topic, as a real memory store does: each node draws most of its
    words from one of `topics` 40-word vocabularies."""
    from cortex_tpu_torch.types import Node, Source
    rng = np.random.default_rng(seed)
    vocab = np.array([f"w{i}" for i in range(topics * 40)])
    kinds = ("fact", "event", "decision", "goal", "observation")
    out = []
    for i in range(n):
        own = vocab[rng.integers(0, topics) * 40 + rng.integers(0, 40, 21)]
        other = rng.choice(vocab, 4)
        title = " ".join(own[:5]) + f" node{seed}x{i}"
        body = " ".join(np.concatenate([own[5:], other]))
        out.append(Node.new(kinds[i % len(kinds)], title, body,
                            Source(agent=f"agent{i % 7}"),
                            float(rng.uniform(0.2, 0.9))))
    return out


def same_hits(want, got):
    """Same scores rank by rank, the same score for every id both lists
    hold, and another id at a rank only where scores tie (a rebuild
    assigns rows, and so tie order, anew)."""
    ws = [s for s, _ in want]
    np.testing.assert_allclose([s for s, _ in got], ws, atol=SCORE_ATOL)
    w = {n.id: s for s, n in want}
    g = {n.id: s for s, n in got}
    for nid in w.keys() | g.keys():
        s = w.get(nid, g.get(nid))
        if nid not in w or nid not in g:      # only a tie at the cut-off
            check(abs(s - ws[-1]) <= SCORE_ATOL, f"{nid} differs")
        else:
            check(abs(w[nid] - g[nid]) <= SCORE_ATOL, f"{nid} rescored")
    for (sw, nw), (_, ng) in zip(want, got):
        if nw.id != ng.id:
            check(abs(g.get(nw.id, sw) - sw) <= SCORE_ATOL
                  and abs(w.get(ng.id, sw) - sw) <= SCORE_ATOL,
                  "rank order differs beyond a tie")


def phase_cortex(dev, workdir):
    from cortex_tpu_torch import Cortex
    from cortex_tpu_torch.config import CortexConfig
    from cortex_tpu_torch.vector import VectorFilter
    from cortex_tpu_torch.vector.embedding import embedding_input
    cfg = CortexConfig()
    cfg.embedding.index = "ivf"
    cfg.embedding.ivf_graph_degree = 0
    cfg.embedding.model = "hash"
    cfg.embedding.dimension = DIM_NODES
    # probe every list: at the default nprobe the capped packing leaves a
    # few rows in lists that rank far from their own vector (phase 3
    # measures the default nprobe), and here each node's own text must
    # return it first
    cfg.embedding.ivf_nprobe = 1 << 20
    path = os.path.join(workdir, "cortex.db")
    cx = Cortex.open(path, cfg, device=dev)
    nodes = seeded_nodes(N_NODES, seed=1)
    t0 = time.monotonic()
    cx.store_batch(nodes)
    t_store = time.monotonic() - t0
    singles = seeded_nodes(4, seed=2)
    for node in singles:
        cx.store(node)
    deleted = nodes[123]
    check(cx.delete_node(deleted.id), "delete_node failed")
    sample = nodes[:4000:100] + singles
    lat = []
    for node in sample:
        text = embedding_input(node)
        t0 = time.monotonic()
        got = cx.search(text, 10)                   # decay + record_access
        lat.append((time.monotonic() - t0) * 1e3)
        check(got and got[0][1].id == node.id,
              f"own text of {node.id} did not return it first")
        got = cx.search(text, 10, flt=VectorFilter(kinds=[node.kind]))
        check(got[0][1].id == node.id and
              all(n.kind == node.kind for _, n in got),
              "kind-filtered search failed")
    others = [n.id for n in nodes[5000:5100]]        # > 64: host bias
    for node in sample[:10]:
        got = cx.search(embedding_input(node), 10,
                        flt=VectorFilter(exclude_ids=others))
        check(got[0][1].id == node.id, "host-bias search lost the node")
        check(not {n.id for _, n in got} & set(others),
              "an excluded node was returned")
    got = cx.search(embedding_input(deleted), 10)
    check(deleted.id not in {n.id for _, n in got},
          "the deleted node was returned")
    check(cx.get_node(sample[0].id).access_count >= 1,
          "record_access did not bump the access count")
    before = [cx.search(embedding_input(n), 10, record_access=False)
              for n in sample]
    co = cx.index._corpus
    nlist = int(co._ivf_dev[0].shape[0])
    partial = default_nprobe_pass(cx, dev, sample)
    cx.close()
    t0 = time.monotonic()
    cx = Cortex.open(path, cfg, device=dev)
    after = [cx.search(embedding_input(n), 10, record_access=False)
             for n in sample]
    t_reopen = time.monotonic() - t0
    check(len(cx.index) == N_NODES + len(singles) - 1,
          "the rebuilt index lost nodes")
    for node, b, a in zip(sample, before, after):
        check(a[0][1].id == node.id, "top-1 changed across the rebuild")
        same_hits(b, a)
        check(deleted.id not in {n.id for _, n in a},
              "the deleted node came back after the rebuild")
    cx.close()
    say("4-cortex", nodes=N_NODES, nlist=nlist, nprobe=nlist,
        store_batch_s=t_store,
        search_ms_p50=statistics.median(lat), self_top1=len(sample),
        reopen_and_search_s=t_reopen, same_after_rebuild=True, **partial)


def default_nprobe_pass(cx, dev, sample):
    """Cortex.search at the default nprobe (decay off, so the hits are
    the index's raw fp32 scores), with and without a kind filter, held
    against the same searches at full probe. Full probe is first held to
    the exact fp32 oracle over the index's host mirror. A partial-probe
    hit scores exactly as in the exact results and never above the
    exact k-th. A node that is not its own top-1 must be stranded: the
    capped packing put it only in lists ranked past nprobe for its own
    vector (ROADMAP C). Recall against the exact top-k is measured and
    printed, not held: hashed text has little cluster structure, so it
    is nprobe-limited."""
    import torch
    from cortex_tpu_torch.vector import VectorFilter
    from cortex_tpu_torch.vector.embedding import embedding_input
    co = cx.index._corpus
    texts = [embedding_input(n) for n in sample]
    qv = np.stack([cx.embedder.embed(t) for t in texts]).astype(np.float32)
    qv /= np.linalg.norm(qv, axis=1, keepdims=True)
    ov, oi = oracle_topk(co._emb_h, co._live_h, qv, K, dev)
    for b, hits in enumerate(cx.index.search_batch(qv, K)):
        hits_match_oracle(hits, ov[b], oi[b], co._id_of, K)

    def run(node, text, kind):
        flt = VectorFilter(kinds=[node.kind]) if kind else None
        return [(n.id, s) for s, n in cx.search(
            text, K, flt=flt, decay=False, record_access=False)]

    cases = [(n, t, kind) for n, t in zip(sample, texts)
             for kind in (False, True)]
    exact = [run(*c) for c in cases]
    full_p = co._nprobe_cfg
    co._nprobe_cfg = 0                         # auto: nlist / 8, >= 8
    nprobe = int(co._nprobe(int(co._ivf_dev[0].shape[0])))
    got = [run(*c) for c in cases]
    co._nprobe_cfg = full_p
    cent, slot_rows = co._ivf_dev[0], co._ivf_dev[3]
    probed = torch.topk(torch.from_numpy(qv).to(cent.device) @ cent.T,
                        nprobe, dim=1).indices
    recall, top1, stranded = [], 0, set()
    for j, ((node, _, _), want, hits) in enumerate(zip(cases, exact, got)):
        w = dict(want)
        for nid, sc in hits:
            if nid in w:
                check(abs(sc - w[nid]) <= SCORE_ATOL, f"{nid} rescored")
            else:
                check(sc <= want[-1][1] + SCORE_ATOL,
                      f"{nid} beats the exact top-{K}")
        recall.append(len(w.keys() & {nid for nid, _ in hits}) / len(want))
        if hits and hits[0][0] == node.id:
            top1 += 1
            continue
        row = co._row_of[node.id]
        check(not bool((slot_rows[probed[j // 2]] == row).any()),  # 2/node
              f"{node.id} lies in a probed list but is not its own top-1")
        stranded.add(node.id)
    recall = float(np.mean(recall))
    return {"default_nprobe": nprobe, "default_recall_at_10": recall,
            "default_self_top1": top1, "default_searches": len(cases),
            "default_stranded_nodes": len(stranded)}


# ------------------------------------------------------------ phase 5


def phase_flat_build(dev, rows, fc):
    """Phase 5 (build): the flat index over phase 3's rows, then phase 2
    at its 1M x 768 planes. Returns (index, timings)."""
    import torch
    from cortex_tpu_torch.vector import TorchFlatIndex
    x_h, ids, kinds, q_np, _ = rows
    index = TorchFlatIndex(x_h.shape[1], device=dev)   # auto, float32
    t0 = time.monotonic()
    index.insert_batch(ids, x_h, kinds=kinds)
    t_insert = time.monotonic() - t0
    t0 = time.monotonic()
    index._corpus.sync()                       # fp32 + int8 planes upload
    torch.cuda.synchronize()
    t_build = time.monotonic() - t0
    info = index.index_info()
    say("5-build", rows=len(ids), dim=int(x_h.shape[1]), **info,
        insert_s=t_insert, upload_s=t_build)
    check(info["resolved_path"] == "quant",
          f"the 1M flat index resolves to {info['resolved_path']}")
    return index, check_flat_real(fc, index, q_np)


def check_flat_real(fc, index, q_np):
    """Phase 2 at the flat index's own planes and 64 real queries: K1
    with cand 64 and 2048, unfiltered, filtered and host bias, each
    followed by K2; then the kernels' and the plain versions' times,
    unfiltered, at batch 64 and 1: K1 at cand 64 (the main path's, k
    bucket 16) and 2048 beside torch._int_mm's product alone, K2 at
    cand 64 and k 16."""
    import torch
    from cortex_tpu_torch.ops import similarity as sim
    co = index._corpus
    emb, live, kinds, agents = co._dev
    emb_i8, rinv = co._dev_q
    q = torch.from_numpy(q_np).to(emb.device)
    qi8, qs = sim.quantize_queries(q)
    host = torch.from_numpy(co._host_bias(
        None, None, [co._id_of[r] for r in range(0, 20000, 97)])).to(
            emb.device)
    biases = flat_biases(live, kinds, agents, None, host=host, agent=0)
    for bias in biases:
        for cand in FLAT_CANDS:
            cv, ci = fc.k1(emb_i8, rinv, qi8, qs, bias, cand)
            for k in (16, 1024):
                if k <= cand:
                    fc.k2(emb, q, cv, ci, k)
    b0 = biases[0]
    out = {"quant_candidates": {}, "quant_rerank": {}}
    cap, d = emb_i8.shape
    for b in (BATCH, 1):
        qb, qib, qsb = q[:b], qi8[:b], qs[:b]
        qp = torch.nn.functional.pad(qib, (0, 0, 0, max(0, 32 - b)))
        product_ms = time_ms(lambda: torch._int_mm(qp, emb_i8.T), 5)
        for cand in FLAT_CANDS:
            nbytes = cap * d + 8 * cap + b * d + 4 * b + 8 * b * cand
            out["quant_candidates"][f"b{b}_cand{cand}"] = timing(
                time_ms(lambda: sim.quant_candidates(emb_i8, rinv, qib, qsb,
                                                     b0, cand), 10),
                time_ms(lambda: sim.quant_candidates_plain(
                    emb_i8, rinv, qib, qsb, b0, cand), 5),
                bound_ms(nbytes, 2 * b * cap * d, INT8_OPS_PER_S),
                int_mm_product_only_ms=product_ms)
        cv, ci = sim.quant_candidates(emb_i8, rinv, qib, qsb, b0,
                                      FLAT_CANDS[0])
        valid = int((cv > -1e29).sum())
        nbytes = 4 * valid * d + 4 * b * d + 8 * cv.numel() + 8 * b * 16
        out["quant_rerank"][f"b{b}"] = timing(
            time_ms(lambda: sim.quant_rerank(emb, qb, cv, ci, 16), 50),
            time_ms(lambda: sim.quant_rerank_plain(emb, qb, cv, ci, 16), 20),
            bound_ms(nbytes, 2 * valid * d, F32_OPS_PER_S))
    say("2-flat-kernels-1M", cands=list(FLAT_CANDS), cases=fc.cases,
        k1_max_abs_err=fc.k1_err, k2_max_abs_err=fc.k2_err, **out)
    return out


def phase_flat_search(index, q_np, q_lat, gen, dev, card):
    """Phase 5 searches: the exact path equals the oracle, auto (quant:
    K1 + K2) recall@10 >= 0.99 with every score exact, throughput and
    latency, then 1,000 inserts and 100 removes in place."""
    co = index._corpus
    ov, oi = oracle_topk(co._emb_h, co._live_h, q_np, K, dev)
    co._search_path = "exact"
    exact = index.search_batch(q_np, K)
    co._search_path = "auto"
    for b in range(len(q_np)):
        hits_match_oracle(exact[b], ov[b], oi[b], co._id_of, K)
    hits = index.search_batch(q_np, K)
    truth = [{co._id_of[r] for r in oi[b][:K]} for b in range(len(q_np))]
    recall = float(np.mean([len({i for i, _ in h} & t) / K
                            for h, t in zip(hits, truth)]))
    for b, h in enumerate(hits):
        rows = [co._row_of[i] for i, _ in h]
        want = co._emb_h[rows] @ q_np[b]
        np.testing.assert_allclose([s for _, s in h], want, atol=SCORE_ATOL)
    check(recall >= 0.99, f"flat auto recall@10 {recall} < 0.99")
    qps, p50, p99 = search_speed(index, q_np, q_lat)
    say("5-search", resolved_path=index.index_info()["resolved_path"],
        exact_path_equals_oracle=True, recall_at_10=recall,
        scores_exact=True, batch64_qps_median=statistics.median(qps),
        batch64_qps_runs=qps, batch1_ms_p50=p50, batch1_ms_p99=p99,
        batch1_queries=len(q_lat), card=card)
    new, _ = clustered_rows(gen, dev, 1000, q_np.shape[1], groups=1000,
                            spread=0.5)
    new_h = new.cpu().numpy()
    new_ids = [f"flatnew{i}" for i in range(len(new_h))]
    step = max(1, len(index) // 100)
    gone = [co._id_of[r] for r in range(0, co._cap, step)
            if co._id_of[r] is not None][:100]
    gone_vecs = co._emb_h[[co._row_of[i] for i in gone]].copy()
    planes = [t.data_ptr() for t in (*co._dev, *co._dev_q)]
    index.insert_batch(new_ids, new_h, kinds=["k9"] * len(new_ids))
    for i in gone:
        check(index.remove(i), f"remove({i}) failed")
    top = index.search_batch(new_h, 1)
    check(planes == [t.data_ptr() for t in (*co._dev, *co._dev_q)],
          "1,100 updates re-uploaded the planes instead of writing in place")
    missed = [i for i, h in zip(new_ids, top) if not h or h[0][0] != i]
    check(not missed, f"{len(missed)} inserted rows are not their own "
          f"top-1, e.g. {missed[:3]}")
    found = {i for h in index.search_batch(gone_vecs, K) for i, _ in h}
    check(not found & set(gone), "a removed row was returned")
    say("5-update", inserted=len(new_ids), removed=len(gone),
        self_top1=True, removed_never_returned=True, in_place=True)


# ------------------------------------------------------------ phase 6


def phase_cortex_flat(dev, workdir):
    """Cortex with CortexConfig() unchanged (flat, float32, auto) on
    SQLite: 20,000 seeded nodes (cap 32,768, so quant: K1 + K2)."""
    from cortex_tpu_torch import Cortex
    from cortex_tpu_torch.config import CortexConfig
    from cortex_tpu_torch.vector import VectorFilter
    from cortex_tpu_torch.vector.embedding import embedding_input
    cfg = CortexConfig()
    path = os.path.join(workdir, "cortex_flat.db")
    cx = Cortex.open(path, cfg, device=dev)
    nodes = seeded_nodes(N_NODES, seed=1)
    t0 = time.monotonic()
    cx.store_batch(nodes)
    t_store = time.monotonic() - t0
    singles = seeded_nodes(4, seed=2)
    for node in singles:
        cx.store(node)
    deleted = nodes[123]
    check(cx.delete_node(deleted.id), "delete_node failed")
    info = cx.index.index_info()
    check(info["kind"] == "flat" and info["resolved_path"] == "quant",
          f"the default config serves through {info}")
    sample = nodes[:4000:100] + singles
    others = [n.id for n in nodes[5000:5100]]        # > 64: host bias
    lat = []
    for node in sample:
        text = embedding_input(node)
        t0 = time.monotonic()
        got = cx.search(text, 10)                   # decay + record_access
        lat.append((time.monotonic() - t0) * 1e3)
        check(got and got[0][1].id == node.id,
              f"own text of {node.id} did not return it first")
        got = cx.search(text, 10, flt=VectorFilter(kinds=[node.kind]))
        check(got[0][1].id == node.id and
              all(n.kind == node.kind for _, n in got),
              "kind-filtered search failed")
    for node in sample[:10]:
        got = cx.search(embedding_input(node), 10,
                        flt=VectorFilter(exclude_ids=others))
        check(got[0][1].id == node.id, "host-bias search lost the node")
        check(not {n.id for _, n in got} & set(others),
              "an excluded node was returned")
    got = cx.search(embedding_input(deleted), 10)
    check(deleted.id not in {n.id for _, n in got},
          "the deleted node was returned")

    def run_all():
        out = []
        for node in sample:
            text = embedding_input(node)
            for flt in (None, VectorFilter(kinds=[node.kind]),
                        VectorFilter(exclude_ids=others)):
                out.append(cx.search(text, 10, flt=flt, decay=False,
                                     record_access=False))
        return out

    before = run_all()
    co = cx.index._corpus
    co._search_path = "exact"
    for want, got in zip(run_all(), before):
        same_hits(want, got)
    co._search_path = "auto"
    cx.close()
    t0 = time.monotonic()
    cx = Cortex.open(path, cfg, device=dev)
    after = run_all()
    t_reopen = time.monotonic() - t0
    check(len(cx.index) == N_NODES + len(singles) - 1,
          "the rebuilt index lost nodes")
    for b, a in zip(before, after):
        same_hits(b, a)
        check(deleted.id not in {n.id for _, n in a},
              "the deleted node came back after the rebuild")
    cx.close()
    say("6-cortex-flat", nodes=N_NODES, capacity=info["capacity"],
        resolved_path=info["resolved_path"], store_batch_s=t_store,
        search_ms_p50=statistics.median(lat), self_top1=len(sample),
        equal_to_exact=len(before), reopen_and_search_s=t_reopen,
        same_after_rebuild=True)


# ------------------------------------------------ phase 2, graph kernels


class GraphKernelCheck:
    """G1 and G2 against their plain versions: G1's overflow flag always
    equal and its depths equal whenever the flag is false (after an
    overflow only the order of the truncated frontier differs, and every
    caller discards that result); the compact walk's flag always equal
    and, without an overflow, its reached count equal and every kept
    (row, depth) pair a true one (all of them when they fit its width),
    each row listed once, and its scratch all INF_DEPTH again
    afterwards; G2's depths equal. max_abs_err is the largest depth
    difference compared (must stay 0)."""

    def __init__(self):
        self.max_abs_err = {"frontier_bfs": 0, "frontier_bfs_compact": 0,
                            "bfs_relax": 0}
        self.cases = 0
        self.overflows = 0

    def walk(self, nb, anchors, hops, cap):
        import torch
        from cortex_tpu_torch.ops import graph_bfs as g
        dist, over = g.frontier_bfs(nb, anchors, hops, cap)
        pdist, pover = g.frontier_bfs_plain(nb, anchors, hops, cap)
        torch.cuda.synchronize()
        check(bool(over) == bool(pover),
              f"G1 overflow flag {bool(over)} != plain {bool(pover)} "
              f"(hops {hops}, cap {cap})")
        if not bool(over):
            err = int((dist.long() - pdist.long()).abs().max())
            check(err == 0, f"G1 depths differ from plain by {err}")
            self.max_abs_err["frontier_bfs"] = max(
                self.max_abs_err["frontier_bfs"], err)
        self.cases += 1
        self.overflows += bool(over)
        return bool(over)

    def compact(self, nb, anchors, hops, cap, out_cap, scratch):
        import torch
        from cortex_tpu_torch.ops import graph_bfs as g
        packed = g.frontier_bfs_compact(nb, anchors, hops, cap, out_cap,
                                        scratch)
        dist, pover = g.frontier_bfs_plain(nb, anchors, hops, cap)
        torch.cuda.synchronize()
        rows, dep, count, over = g.unpack_compact(packed.cpu())
        check(over == bool(pover), f"compact walk overflow flag {over} != "
              f"plain {bool(pover)} (hops {hops}, cap {cap})")
        check(rows.unique().numel() == rows.numel() == min(count, out_cap),
              "the compact walk listed a row twice")
        check(bool((scratch == g.INF_DEPTH).all()),
              "the compact walk left its scratch changed")
        if not over:
            dist = dist.cpu()
            reached = int((dist <= hops).sum())
            check(count == reached, f"compact walk reached {count} rows, "
                  f"plain {reached}")
            err = int((dist[rows.long()].long() - dep.long()).abs().max()) \
                if rows.numel() else 0
            check(err == 0, f"compact walk depths differ from plain by {err}")
            self.max_abs_err["frontier_bfs_compact"] = max(
                self.max_abs_err["frontier_bfs_compact"], err)
        self.cases += 1
        self.overflows += over
        return over

    def relax(self, nb, dist0, hops):
        import torch
        from cortex_tpu_torch.ops import graph_bfs as g
        got = g.bfs_relax(nb, dist0, hops)
        want = g.bfs_relax_plain(nb, dist0, hops)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        check(err == 0, f"G2 depths differ from plain by {err}")
        self.max_abs_err["bfs_relax"] = max(self.max_abs_err["bfs_relax"],
                                            err)
        self.cases += 1


def graph_table(dev, gen, n, d, mean_deg, hubs):
    """[n, d] int32 neighbour table packed left as the mirror builds it:
    Poisson(mean_deg) uniform neighbours a row, hub rows (share `hubs`)
    truncated at the full width d, -1 after."""
    import torch
    deg = torch.poisson(torch.full((n,), float(mean_deg), device=dev),
                        generator=gen)
    deg[torch.rand(n, device=dev, generator=gen) < hubs] = d
    nb = torch.randint(0, n, (n, d), dtype=torch.int32, device=dev,
                       generator=gen)
    nb.masked_fill_(torch.arange(d, device=dev)[None, :] >= deg[:, None], -1)
    return nb


def graph_anchors(dev, gen, n, a):
    """a anchors with a duplicate and a -1 pad among them (a >= 3)."""
    import torch
    out = torch.randint(0, n, (a,), dtype=torch.int32, device=dev,
                        generator=gen)
    if a >= 3:
        out[1] = out[0]
        out[-1] = -1
    return out


def sources(dev, anchors, n):
    """dist0 [A, n]: depth 0 at each valid anchor's row, INF elsewhere."""
    import torch
    from cortex_tpu_torch.ops.graph_bfs import INF_DEPTH
    valid = anchors[anchors >= 0].long()
    dist0 = torch.full((max(1, valid.numel()), n), INF_DEPTH,
                       dtype=torch.int32, device=dev)
    dist0[torch.arange(valid.numel(), device=dev), valid] = 0
    return dist0


def check_graph_small(gc, dev, gen):
    """Phase 2, graph kernels at small odd shapes: duplicate, padded and
    isolated anchors, caps that overflow at every hop and caps that do
    not, 0 to 8 hops (9 for G2, which takes min(hops, 8) rounds)."""
    import torch
    from cortex_tpu_torch.ops import graph_bfs as g
    for n, d, mean, a in ((1, 8, 0.5, 1), (37, 5, 2.0, 4),
                          (1000, 16, 3.0, 8), (4099, 64, 9.0, 64)):
        nb = graph_table(dev, gen, n, d, mean, 0.01)
        anchors = graph_anchors(dev, gen, n, a)
        scratch = torch.full((n,), g.INF_DEPTH, dtype=torch.int32,
                             device=dev)
        for cap in sorted({a, 16, 300, GRAPH_CAP} - set(range(a))):
            for hops in (0, 1, 2, 3, 8):
                gc.walk(nb, anchors, hops, cap)
                for out_cap in (64, GRAPH_OUT_CAP):
                    gc.compact(nb, anchors, hops, cap, out_cap, scratch)
        dist0 = sources(dev, anchors, n)
        for hops in (0, 1, 3, 8, 9):
            gc.relax(nb, dist0, hops)
        if a > 1:                     # whole tiles of 8 anchors and a part
            gc.relax(nb, sources(dev, graph_anchors(dev, gen, n, a + 3), n),
                     3)
    iso = torch.full((64, 8), -1, dtype=torch.int32, device=dev)
    iso[0, :2] = torch.tensor([1, 2], dtype=torch.int32)
    for a in ([40], [40, 40, -1], [0, 63]):
        anchors = torch.tensor(a, dtype=torch.int32, device=dev)
        gc.walk(iso, anchors, 3, 8)
        gc.compact(iso, anchors, 3, 8, 16,
                   torch.full((64,), g.INF_DEPTH, dtype=torch.int32,
                              device=dev))
        gc.relax(iso, sources(dev, anchors, 64), 3)
    try:
        g.frontier_bfs(iso, torch.tensor([64], dtype=torch.int32,
                                         device=dev), 2, 8)
    except ValueError:
        pass
    else:
        raise AssertionError("G1 took an anchor outside the table")
    check(0 < gc.overflows < gc.cases, "the small graph cases did not "
          "cover both sides of the frontier cap")


def walk_bytes(nb, anchors, hops, cap, *, compact=False):
    """The bytes G1 must move for these inputs: the anchors read and
    seeded, and per hop the frontier slots read, the live rows gathered,
    one dist entry read per pair, and the next frontier written (replays
    the walk's counts on the device); then frontier_bfs's dist [N]
    written once, or the compact walk's output: its reached (row, depth)
    pairs, the count and the flag."""
    import torch
    from cortex_tpu_torch.ops.graph_bfs import INF_DEPTH
    n, d = nb.shape
    dist = torch.full((n,), INF_DEPTH, dtype=torch.int32, device=nb.device)
    dist[anchors[anchors >= 0].long()] = 0
    total = 8 * anchors.numel()
    front = anchors
    for h in range(hops):
        front = front[:cap]
        live = front[front >= 0]
        pairs = nb[live.long()].reshape(-1)
        pairs = pairs[(pairs >= 0) & (pairs < n)]
        new = pairs[dist[pairs.long()] == INF_DEPTH]
        dist[new.long()] = h + 1
        total += 4 * (front.numel() + d * live.numel() + pairs.numel()
                      + min(cap, new.numel()))
        front = new
    if compact:
        return total + 8 + 8 * int((dist < INF_DEPTH).sum())
    return total + 4 * n


def check_graph_big(gc, dev, gen, card):
    """Phase 2 at the 100M-edge tier's table (GRAPH_ROWS x 64): G1 (both
    forms; the compact walk at out_cap 16,384 on one scratch) with 1 and
    8 anchors at 3 and 8 hops, G2 with 1 and 8 anchors at 3 and 8
    rounds, each against its plain version; then device times beside
    the bounds."""
    import torch
    from cortex_tpu_torch.ops import graph_bfs as g
    t0 = time.monotonic()
    nb = graph_table(dev, gen, GRAPH_ROWS, GRAPH_DEG, GRAPH_MEAN_DEG,
                     GRAPH_HUBS)
    torch.cuda.synchronize()
    t_gen = time.monotonic() - t0
    live = int((nb >= 0).sum())
    anchors = {a: torch.randint(0, GRAPH_ROWS, (a,), dtype=torch.int32,
                                device=dev, generator=gen) for a in (1, 8)}
    scratch = torch.full((GRAPH_ROWS,), g.INF_DEPTH, dtype=torch.int32,
                         device=dev)
    ops = g.load_ops()
    flags = {}
    for a, anc in anchors.items():
        for hops in (3, 8):
            flags[f"a{a}_h{hops}"] = gc.walk(nb, anc, hops, GRAPH_CAP)
            check(gc.compact(nb, anc, hops, GRAPH_CAP, GRAPH_OUT_CAP, scratch)
                  == flags[f"a{a}_h{hops}"], "the two walks' flags differ")
        for hops in (3, 8):
            gc.relax(nb, sources(dev, anc, GRAPH_ROWS), hops)
    out = {"frontier_bfs": {}, "frontier_bfs_compact": {}, "bfs_relax": {}}
    n, d = nb.shape
    for a, anc in anchors.items():
        hops = 3
        # ms: the wrapper from host anchors, as the mirror calls it (its
        # range check then needs no host sync); op_ms: the op alone
        key = f"a{a}_h{hops}"
        host = anc.cpu()
        out["frontier_bfs"][key] = timing(
            time_ms(lambda: g.frontier_bfs(nb, host, hops, GRAPH_CAP), 20),
            time_ms(lambda: g.frontier_bfs_plain(nb, anc, hops, GRAPH_CAP),
                    3),
            bound_ms(walk_bytes(nb, anc, hops, GRAPH_CAP), 0,
                     F32_OPS_PER_S),
            overflow=flags[key],
            op_ms=time_ms(
                lambda: ops.frontier_bfs(nb, anc, hops, GRAPH_CAP), 20))
        args = (nb, anc, hops, GRAPH_CAP, GRAPH_OUT_CAP)
        out["frontier_bfs_compact"][key] = timing(
            time_ms(lambda: g.frontier_bfs_compact(
                nb, host, *args[2:], scratch), 20),
            time_ms(lambda: g.frontier_bfs_compact_plain(*args), 3),
            bound_ms(walk_bytes(nb, anc, hops, GRAPH_CAP, compact=True), 0,
                     F32_OPS_PER_S),
            overflow=flags[key],
            op_ms=time_ms(lambda: ops.frontier_bfs_compact(*args, scratch),
                          20),
            reached=g.unpack_compact(
                g.frontier_bfs_compact(*args, scratch).cpu())[2])
        dist0 = sources(dev, anc, GRAPH_ROWS)
        for rounds in (3, 8):
            out["bfs_relax"][f"a{a}_r{rounds}"] = timing(
                time_ms(lambda: g.bfs_relax(nb, dist0, rounds), 5),
                time_ms(lambda: g.bfs_relax_plain(nb, dist0, rounds), 1),
                bound_ms(rounds * (4 * n * d + 8 * a * n), 0,
                         F32_OPS_PER_S))
    check(bool((scratch == g.INF_DEPTH).all()),
          "the timed compact walks left their scratch changed")
    say("2-graph-kernels-10M", rows=n, width=d, neighbours=live,
        gen_s=t_gen, cases=gc.cases, overflows=gc.overflows,
        walk_overflow=flags, max_abs_err=gc.max_abs_err, card=card, **out)
    return out


# ------------------------------------------------------------ phase 7


def seeded_edges(member, n_edges, seed, cap=GRAPH_DEG):
    """(src, dst) row arrays of about n_edges distinct directed edges
    over the rows of phase 3: Pareto-tailed out-degree, 80 % of the
    targets in the row's own cluster and 20 % anywhere, no self loops
    (a storage holds one edge a pair and relation), every 1000th row
    (i % 1000 == 999) without edges, and at most `cap` distinct
    neighbours a row (each row keeps its first `cap` in a seeded order),
    so the device table truncates no row and every tier's depths are
    exact."""
    rng = np.random.default_rng(seed)
    n = len(member)
    linked = np.arange(n) % 1000 != 999
    w = rng.pareto(2.0, n) + 1.0
    w[~linked] = 0.0
    src = np.repeat(np.arange(n, dtype=np.int64),
                    rng.poisson(w * (n_edges / w.sum())))
    order = np.argsort(member, kind="stable")
    sizes = np.bincount(member)
    starts = np.concatenate(([0], np.cumsum(sizes)[:-1]))
    c = member[src]
    local = order[starts[c] + (rng.random(len(src)) * sizes[c]).astype(
        np.int64)]
    dst = np.where(rng.random(len(src)) < 0.8, local,
                   rng.integers(0, n, len(src)))
    keep = (dst != src) & linked[dst]
    src, dst = src[keep], dst[keep]
    pairs, inv = np.unique(np.minimum(src, dst) * n + np.maximum(src, dst),
                           return_inverse=True)
    pri = rng.random(len(pairs))
    ends = np.concatenate((pairs // n, pairs % n))
    pid = np.concatenate((np.arange(len(pairs)),) * 2)
    o = np.lexsort((np.concatenate((pri, pri)), ends))
    rank = np.arange(len(o)) - np.searchsorted(ends[o], ends[o])
    ok = np.ones(len(pairs), bool)
    ok[pid[o][rank >= cap]] = False
    keep = ok[inv.reshape(-1)]
    src, dst = src[keep], dst[keep]
    _, first = np.unique(src * n + dst, return_index=True)  # one per pair
    first.sort()
    return src[first], dst[first]


def packed_snapshot(src, dst, ids):
    """PackedAdjacency of the directed edges (src, dst) over `ids`, from
    the arrays through its constructor: the same interning-free
    undirected, deduplicated CSR that PackedAdjacency.build makes from
    storage.edge_endpoints (5M put_edge calls and build's interning of
    10M id strings in Python would crowd the time limit; phase 7 checks
    the two agree on the edges inside 400 clusters)."""
    from cortex_tpu_torch.graph.packed import PackedAdjacency
    n = len(ids)
    present = np.unique(np.concatenate((src, dst)))
    row = np.full(n, -1, np.int64)
    row[present] = np.arange(len(present))
    m = len(present)
    u, v = row[src], row[dst]
    key = np.unique(np.concatenate((u * m + v, v * m + u)))
    indptr = np.zeros(m + 1, np.int64)
    np.cumsum(np.bincount(key // m, minlength=m), out=indptr[1:])
    pid = [ids[i] for i in present.tolist()]
    return PackedAdjacency(pid, {s: j for j, s in enumerate(pid)}, indptr,
                           (key % m).astype(np.int32), len(src))


def check_snapshot_subset(src, dst, ids, kinds, member):
    """The constructor's snapshot equals PackedAdjacency.build over a
    real MemoryStorage on the edges inside the first 400 clusters (~20,000
    rows): the same neighbour sets and multi_bfs depths by id."""
    from cortex_tpu_torch.graph.packed import UNREACHED, PackedAdjacency
    from cortex_tpu_torch.storage import MemoryStorage
    from cortex_tpu_torch.types import Edge, EdgeProvenance, Node, Source
    sub = (member[src] < 400) & (member[dst] < 400)
    s, t = src[sub], dst[sub]
    st = MemoryStorage()
    agent = Source(agent="seed")
    st.put_nodes_batch(Node(id=ids[i], kind=kinds[i], title=ids[i],
                            body="", source=agent)
                       for i in np.nonzero(member < 400)[0].tolist())
    prov = EdgeProvenance.manual("seed")
    st.bulk_put_edges(Edge.new(ids[a], ids[b], "related_to", 0.5, prov)
                      for a, b in zip(s.tolist(), t.tolist()))
    real = PackedAdjacency.build(st)
    mine = packed_snapshot(s, t, ids)
    check(set(real.ids) == set(mine.ids) and real.edge_count
          == mine.edge_count, "snapshot ids or edge count differ")
    for nid in real.ids[:2000]:
        r, q = real.row_of[nid], mine.row_of[nid]
        check({real.ids[j] for j in
               real.indices[real.indptr[r]:real.indptr[r + 1]]}
              == {mine.ids[j] for j in
                  mine.indices[mine.indptr[q]:mine.indptr[q + 1]]},
              f"snapshot neighbours of {nid} differ")
    for nid in real.ids[:20]:
        a = real.multi_bfs([real.row_of[nid]], 3)
        b = mine.multi_bfs([mine.row_of[nid]], 3)
        check({real.ids[i]: int(x) for i, x in enumerate(a)
               if x != UNREACHED}
              == {mine.ids[i]: int(x) for i, x in enumerate(b)
                  if x != UNREACHED}, f"snapshot depths from {nid} differ")
    return int(sub.sum())


class QueryTable:
    """An embedder for HybridSearch whose 'texts' are keys of seeded
    768-d query vectors (phase 7 searches phase 3's vector space)."""

    def __init__(self, vecs):
        self.vecs = vecs
        self.dimension = next(iter(vecs.values())).shape[0]

    def embed(self, key):
        return self.vecs[key]


def fuse_oracle(hits, anchors, depth_of, hops, w, limit, storage):
    """HybridSearch's fusion, written out over (id, vector score) hits in
    vector order: tombstones skipped, graph score 1/(1+d) from the
    nearest anchor that reaches the node within `hops` (depth_of(anchor)
    -> {id: depth}, over the anchors that have edges), an anchor 1.0 to
    itself, combined w*v + (1-w)*g, stable sort, top `limit`. Without
    anchors, the vector hits as they come (combined = v)."""
    if not anchors:
        rows = [(nid, v, 0.0, v, None) for nid, v in hits
                if (lambda n: n is not None and not n.deleted)(
                    storage.get_node(nid))]
        return rows[:limit]
    known = [a for a in anchors if depth_of(a) is not None]
    depths = [depth_of(a) for a in known]
    out = []
    for nid, v in hits:
        node = storage.get_node(nid)
        if node is None or node.deleted:
            continue
        g, nearest = 0.0, None
        ds = [dm.get(nid, 1 << 30) for dm in depths]
        if ds:
            j = int(np.argmin(ds))
            if ds[j] <= hops:
                g, nearest = 1.0 / (1.0 + ds[j]), (known[j], ds[j])
        if nid in anchors and g < 1.0:
            g, nearest = 1.0, (nid, 0)
        out.append((nid, v, g, w * v + (1.0 - w) * g, nearest))
    out.sort(key=lambda r: -r[3])
    return out[:limit]


def same_hybrid(want, got, what):
    """HybridResults against fuse_oracle rows: combined scores rank by
    rank within SCORE_ATOL, graph scores and nearest anchors exactly
    equal for every id both hold, vector scores within SCORE_ATOL, and
    another id at a rank only where combined scores tie."""
    check(len(got) == len(want), f"{what}: {len(got)} results, want "
          f"{len(want)}")
    wc = [r[3] for r in want]
    np.testing.assert_allclose([r.combined_score for r in got], wc,
                               atol=SCORE_ATOL)
    w = {r[0]: r for r in want}
    for r in got:
        o = w.get(r.node.id)
        if o is None:
            check(abs(r.combined_score - wc[-1]) <= SCORE_ATOL,
                  f"{what}: {r.node.id} is no tie at the cut-off")
            continue
        check(r.graph_score == o[2] and r.nearest_anchor == o[4],
              f"{what}: graph score of {r.node.id} {r.graph_score} "
              f"{r.nearest_anchor} != {o[2]} {o[4]}")
        check(abs(r.vector_score - o[1]) <= SCORE_ATOL,
              f"{what}: vector score of {r.node.id} differs")
    for o, r in zip(want, got):
        if o[0] != r.node.id:
            check(abs(o[3] - r.combined_score) <= SCORE_ATOL,
                  f"{what}: rank order differs beyond a tie")


def results_key(res):
    return [(r.node.id, r.vector_score, r.graph_score, r.nearest_anchor)
            for r in res]


def as_oracle(res):
    """HybridResults as fuse_oracle rows (to hold one run to another)."""
    return [(r.node.id, r.vector_score, r.graph_score, r.combined_score,
             r.nearest_anchor) for r in res]


class LegClock:
    """Splits HybridSearch.search's host time: the vector leg (enqueue
    plus the fetch's wait), the proximity leg (mirror.per_anchor) and
    the rest (fusion and hydration). Wraps the instances' methods."""

    def __init__(self, hybrid):
        self.hybrid = hybrid
        self.vector = self.proximity = 0.0
        index, mirror = hybrid.index, hybrid.mirror
        enqueue, per_anchor = index.search_batch_async, mirror.per_anchor

        def timed_enqueue(*a, **kw):
            t0 = time.perf_counter()
            fetch = enqueue(*a, **kw)
            self.vector += time.perf_counter() - t0

            def timed_fetch():
                t1 = time.perf_counter()
                hits = fetch()
                self.vector += time.perf_counter() - t1
                return hits
            return timed_fetch

        def timed_per_anchor(*a, **kw):
            t0 = time.perf_counter()
            out = per_anchor(*a, **kw)
            self.proximity += time.perf_counter() - t0
            return out

        index.search_batch_async = timed_enqueue
        mirror.per_anchor = timed_per_anchor

    def run(self, queries):
        legs = {"total": [], "vector": [], "proximity": [], "fusion": []}
        for q in queries:
            self.vector = self.proximity = 0.0
            t0 = time.perf_counter()
            self.hybrid.search(q)
            total = time.perf_counter() - t0
            for k, v in (("total", total), ("vector", self.vector),
                         ("proximity", self.proximity),
                         ("fusion", total - self.vector - self.proximity)):
                legs[k].append(v * 1e3)
        return {f"{k}_ms_p50_p99": [float(x) for x in
                                    np.percentile(v, [50, 99])]
                for k, v in legs.items()}

    def close(self):
        del self.hybrid.index.search_batch_async
        del self.hybrid.mirror.per_anchor


def hybrid_setup(dev, index, rows):
    """Phase 7's set-up at BASELINE config #4 on `index` (phase 5's flat
    index over phase 3's rows): 1M light nodes in a MemoryStorage, ~5M
    seeded edges in the packed snapshot (packed_snapshot, checked
    against the real build on a subset), a DeviceGraphMirror serving it,
    HybridSearch, and HYB_QUERIES queries (limit 17, 2-hop anchors: no
    anchors, two, one with a kind filter, and an edge-less one)."""
    from types import SimpleNamespace
    from cortex_tpu_torch.graph.cache import AdjacencyCache
    from cortex_tpu_torch.graph.csr import DeviceGraphMirror
    from cortex_tpu_torch.storage import MemoryStorage
    from cortex_tpu_torch.types import Node, Source
    from cortex_tpu_torch.vector.hybrid import HybridQuery, HybridSearch
    _, ids, kinds, _, member = rows
    co = index._corpus
    t0 = time.monotonic()
    storage = MemoryStorage()
    agent = Source(agent="seed")
    storage.put_nodes_batch(Node(id=i, kind=k, title=i, body="",
                                 source=agent) for i, k in zip(ids, kinds))
    t_nodes = time.monotonic() - t0
    t0 = time.monotonic()
    # ~8.5 % of the drawn edges go to the degree cap and to duplicates
    src, dst = seeded_edges(member, int(HYB_EDGES * 1.093), seed=17)
    pk = packed_snapshot(src, dst, ids)
    t_edges = time.monotonic() - t0
    subset_edges = check_snapshot_subset(src, dst, ids, kinds, member)
    mirror = DeviceGraphMirror(AdjacencyCache(storage), storage=storage,
                               device=dev)
    mirror._packed, mirror._packed_version = pk, mirror._cache.version
    check(mirror._packed_mode() and mirror._ensure_packed() is pk,
          "the mirror does not serve the packed snapshot")
    rng = np.random.default_rng(23)
    vecs, cases = {}, []
    def usable(i):
        lonely = (i // 1000) * 1000 + 999
        return (ids[i] in pk.row_of and ids[i] in co._row_of
                and lonely < len(ids) and ids[lonely] in co._row_of)

    linked = [i for i in rng.integers(0, len(ids), 4 * HYB_QUERIES).tolist()
              if usable(i)][:HYB_QUERIES]
    check(len(linked) == HYB_QUERIES, "too few query rows")
    for j, i in enumerate(linked):
        r = pk.row_of[ids[i]]
        nbr = pk.ids[int(pk.indices[pk.indptr[r]])]
        kind = j % 4
        if kind == 3:                      # an edge-less anchor, near it
            i = (i // 1000) * 1000 + 999
        x = co._emb_h[co._row_of[ids[i]]]
        q = x + 0.35 * rng.standard_normal(x.shape[0]).astype(
            np.float32) / x.shape[0] ** 0.5
        vecs[f"q{j}"] = (q / np.linalg.norm(q)).astype(np.float32)
        anchors = {0: [], 1: [nbr, ids[i]], 2: [nbr],
                   3: [ids[i], nbr]}[kind]
        cases.append(HybridQuery(
            query_text=f"q{j}", anchors=anchors, limit=HYB_LIMIT,
            max_anchor_depth=HYB_HOPS,
            kind_filter=["k1", "k3"] if kind == 2 else None))
    return SimpleNamespace(
        storage=storage, pk=pk, mirror=mirror, vecs=vecs, cases=cases,
        hybrid=HybridSearch(storage, QueryTable(vecs), index, mirror),
        ids=ids, edges=int(len(src)), t_nodes=t_nodes, t_edges=t_edges,
        subset_edges=subset_edges)


def phase_hybrid(dev, index, rows, gc, card):
    """Phase 7: HybridSearch at BASELINE config #4 on phase 5's flat index
    (1M x 768; hybrid_setup). Every case against fuse_oracle over the
    index's hits with exact fp32 scores and multi_bfs depths; the host
    tier, then every anchor through the compact walk
    (HOST_FRONTIER_BUDGET = 0) with the same results; then the batch-1
    latency of both tiers, split by leg."""
    import torch
    from cortex_tpu_torch.graph.packed import UNREACHED
    hy = hybrid_setup(dev, index, rows)
    storage, pk, mirror, vecs, cases, hybrid, ids = (
        hy.storage, hy.pk, hy.mirror, hy.vecs, hy.cases, hy.hybrid, hy.ids)
    co = index._corpus
    bfs_cache = {}

    def depth_of(a):
        if a not in pk.row_of:
            return None
        if a not in bfs_cache:
            d = pk.multi_bfs([pk.row_of[a]], HYB_HOPS)
            hit = np.nonzero(d != UNREACHED)[0]
            bfs_cache[a] = {pk.ids[h]: int(d[h]) for h in hit.tolist()}
        return bfs_cache[a]

    def oracle(q):
        from cortex_tpu_torch.vector import VectorFilter
        flt = VectorFilter(kinds=q.kind_filter) if q.kind_filter else None
        qv = vecs[q.query_text]
        hits = index.search(qv, 3 * q.limit, flt)
        exact = [(nid, float(co._emb_h[co._row_of[nid]] @ qv))
                 for nid, _ in hits]
        return fuse_oracle(exact, q.anchors, depth_of, q.max_anchor_depth,
                           q.vector_weight, q.limit, storage)

    host = [hybrid.search(q) for q in cases]
    for j, (q, got) in enumerate(zip(cases, host)):
        same_hybrid(oracle(q), got, f"host tier, query {j}")
        if q.anchors and j % 4 == 3:
            check(any(r.node.id == q.anchors[0] and r.graph_score == 1.0
                      for r in got), f"query {j}: the edge-less anchor "
                  f"is missing or scored below 1")
        if q.kind_filter:
            check(all(r.node.kind in q.kind_filter for r in got),
                  "the kind filter let another kind through")
    scored = sum(r.graph_score > 0 for res in host for r in res)
    check(scored > 0, "no result took a graph score")
    mirror.HOST_FRONTIER_BUDGET = 0
    walks = _wrappers()["frontier_bfs_compact"].launches
    device = [hybrid.search(q) for q in cases]
    walks = _wrappers()["frontier_bfs_compact"].launches - walks
    for j, (a, b) in enumerate(zip(host, device)):
        check(results_key(a) == results_key(b),
              f"query {j}: the device tier differs from the host tier")
    check(walks == sum(len([a for a in q.anchors if a in pk.row_of])
                       for q in cases), f"{walks} device walks")
    check(mirror.packed_overflows == 0, "a device walk fell back")
    with uncounted():                 # G1 at the main path's shapes
        nbrs = mirror._packed_device_nbrs(pk)
        scratch = mirror._packed_device_scratch(pk, nbrs)
        for q in cases:
            for a in q.anchors:
                if a in pk.row_of:
                    args = (nbrs, torch.tensor([pk.row_of[a]],
                                               dtype=torch.int32,
                                               device=dev),
                            min(q.max_anchor_depth, mirror.HOP_CAP),
                            mirror.DEVICE_FRONTIER_CAP)
                    gc.walk(*args)
                    gc.compact(*args, mirror.PACKED_OUT_CAP, scratch)
    lat_q = [cases[j % len(cases)] for j in range(HYB_LAT)
             if cases[j % len(cases)].anchors]
    clock = LegClock(hybrid)
    lat = {}
    for tier, budget in (("host", type(mirror).HOST_FRONTIER_BUDGET),
                         ("device", 0)):
        mirror.HOST_FRONTIER_BUDGET = budget
        clock.run(lat_q[:20])                         # warm
        lat[tier] = clock.run(lat_q)
    clock.close()
    say("7-hybrid", nodes=len(ids), edges=hy.edges,
        snapshot_rows=pk.n, snapshot_pairs=int(len(pk.indices)),
        max_degree=int(np.diff(pk.indptr).max()),
        subset_edges=hy.subset_edges, nodes_s=hy.t_nodes,
        edges_and_snapshot_s=hy.t_edges,
        queries=len(cases), results_with_graph_score=int(scored),
        device_walks=walks, graph_cases=gc.cases, limit=HYB_LIMIT,
        hops=HYB_HOPS,
        batch1_latency=lat, latency_queries=len(lat_q), card=card)
    del mirror, hybrid, hy
    torch.cuda.empty_cache()


def profile_hybrid(dev, index, rows, card):
    """--profile for config #4's device tier (hybrid_setup on the flat
    index, HOST_FRONTIER_BUDGET = 0): PROFILE_ROUNDS searches with
    anchors traced with torch.profiler. Spans: H0 search_hybrid (the
    whole search), H1 the vector leg (enqueue, and the fetch that waits
    for the device), H2 the proximity leg (mirror.per_anchor: the
    compact walk, its fetch and the depth map); fusion and hydration are
    H0 less H1 and H2. Device ms per kernel and the device's idle share
    of the traced wall, as profile_layers reads them."""
    from pathlib import Path
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    import torch
    hy = hybrid_setup(dev, index, rows)
    mirror, hybrid = hy.mirror, hy.hybrid
    mirror.HOST_FRONTIER_BUDGET = 0
    enqueue, per_anchor = index.search_batch_async, mirror.per_anchor

    def spanned_enqueue(*a, **kw):
        with record_function("H1.vector_enqueue"):
            fetch = enqueue(*a, **kw)

        def spanned_fetch():
            with record_function("H1.vector_fetch"):
                return fetch()
        return spanned_fetch

    def spanned_per_anchor(*a, **kw):
        with record_function("H2.per_anchor"):
            return per_anchor(*a, **kw)

    index.search_batch_async = spanned_enqueue
    mirror.per_anchor = spanned_per_anchor
    qs = [q for q in hy.cases if q.anchors][:PROFILE_ROUNDS]
    for q in qs:
        hybrid.search(q)
    torch.cuda.synchronize()
    walks = _wrappers()["frontier_bfs_compact"].launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for q in qs:
            with record_function("H0.search_hybrid"):
                hybrid.search(q)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / len(qs)
    walks = _wrappers()["frontier_bfs_compact"].launches - walks
    del index.search_batch_async, mirror.per_anchor
    host, devt = {}, {}
    for e in prof.key_averages():
        # spans (these, and profile_layers' on the index's corpus) have a
        # device-side range over the kernels they launched: left out
        if e.key.startswith(("H0.", "H1.", "H2.", "L0.", "L1.", "L2.",
                             "L4.")):
            if e.device_type != DeviceType.CUDA and e.key[0] == "H":
                host[e.key] = e.cpu_time_total / 1e3 / len(qs)
        elif e.device_type == DeviceType.CUDA:
            devt[e.key[:80]] = e.self_device_time_total / 1e3 / len(qs)
    host["fusion_and_hydration"] = host.get("H0.search_hybrid", 0.0) - sum(
        v for k, v in host.items() if k.startswith(("H1.", "H2.")))
    busy = sum(devt.values())
    say("profile-hybrid-device-tier", rounds=len(qs), traced_wall_ms=wall,
        device_busy_ms=busy, device_idle_share=1 - busy / wall,
        host_ms=host,
        device_ms=dict(sorted(devt.items(), key=lambda kv: -kv[1])[:8]),
        walk_launches=walks, card=card)
    out_dir = Path(__file__).resolve().parent / "profile_out"
    out_dir.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(out_dir / "trace_hybrid_device.json"))
    del mirror, hybrid, hy
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phase 8


def host_bfs(adj, srcs, hops):
    """{id: depth} within `hops` of srcs over adjacency dict adj."""
    dist = {s: 0 for s in srcs}
    front = list(srcs)
    for h in range(hops):
        nxt = []
        for u in front:
            for v in adj.get(u, ()):
                if v not in dist:
                    dist[v] = h + 1
                    nxt.append(v)
        if not nxt:
            break
        front = nxt
    return dist


def phase_cortex_graph(dev, workdir, gc, card):
    """Phase 8: Cortex with edges on phase 6's store (CortexConfig(), the
    object-cache tier): CX_EDGES seeded create_edge calls, then
    search_hybrid against fuse_oracle (depths from a plain BFS over the
    seeded edges), delete_edge, traverse / neighborhood / find_paths
    against a host BFS, the device tiers (G2 through per_anchor, G1 then
    G2 through depths_from with the frontier cap forced to overflow),
    and the same after a reopen."""
    from cortex_tpu_torch import Cortex
    from cortex_tpu_torch.config import CortexConfig
    from cortex_tpu_torch.graph import BOTH, OUTGOING, PathRequest
    from cortex_tpu_torch.graph import TraversalRequest
    from cortex_tpu_torch.types import Edge, EdgeProvenance
    from cortex_tpu_torch.vector.embedding import embedding_input
    path = os.path.join(workdir, "cortex_flat.db")
    cx = Cortex.open(path, CortexConfig(), device=dev)
    nodes = sorted(cx.list_nodes(), key=lambda n: n.id)
    ids = [n.id for n in nodes]
    rng = np.random.default_rng(31)
    prov = EdgeProvenance.manual("seed")
    made, edges = set(), []
    t0 = time.monotonic()
    while len(edges) < CX_EDGES:
        a = int(rng.integers(0, len(ids)))
        b = (a + int(rng.integers(1, 40))) % len(ids)
        if (a, b) in made or (b, a) in made:
            continue
        made.add((a, b))
        e = Edge.new(ids[a], ids[b], "related_to",
                     float(rng.uniform(0.2, 1.0)), prov)
        cx.create_edge(e)
        edges.append(e)
    t_edges = time.monotonic() - t0

    def adjacency(es):
        und, out = {}, {}
        for e in es:
            und.setdefault(e.from_id, []).append(e.to_id)
            und.setdefault(e.to_id, []).append(e.from_id)
            out.setdefault(e.from_id, []).append(e.to_id)
        return und, out

    und, out_adj = adjacency(edges)
    co = cx.index._corpus
    sample = nodes[:2000:50]
    queries = []
    for j, node in enumerate(sample):
        nbr = und.get(node.id, [edges[j].from_id])[0]     # has an edge
        anchors = {0: [], 1: [nbr], 2: [nbr, node.id]}[j % 3]
        queries.append((embedding_input(node), anchors,
                        [node.kind] if j % 5 == 4 else None))

    def oracle(text, anchors, kinds, adj):
        from cortex_tpu_torch.vector import VectorFilter
        emb = cx.embedder.embed(text)
        qv = (emb / np.linalg.norm(emb)).astype(np.float32)
        flt = VectorFilter(kinds=kinds) if kinds else None
        hits = cx.index.search(emb, 30, flt)
        exact = [(nid, float(co._emb_h[co._row_of[nid]] @ qv))
                 for nid, _ in hits]
        return fuse_oracle(
            exact, anchors,
            lambda a: host_bfs(adj, [a], 3) if a in adj else None,
            3, 0.7, 10, cx.storage)

    lat = []

    def run_all(adj, what):
        got = []
        for j, (text, anchors, kinds) in enumerate(queries):
            t0 = time.perf_counter()
            res = cx.search_hybrid(text, anchors, 10, kind_filter=kinds)
            lat.append((time.perf_counter() - t0) * 1e3)
            same_hybrid(oracle(text, anchors, kinds, adj), res,
                        f"{what}, query {j}")
            got.append(res)
        return got

    before = run_all(und, "host tier")
    host_ms = statistics.median(lat)
    # traverse / neighborhood / find_paths against a host BFS
    for node in sample[:20]:
        want = host_bfs(und, [node.id], 2)
        check(cx.neighborhood(node.id, 2).depths == want,
              "neighborhood depths differ from a host BFS")
        sub = cx.traverse(TraversalRequest(start=[node.id], max_depth=3,
                                           direction=OUTGOING))
        check(sub.depths == host_bfs(out_adj, [node.id], 3),
              "traverse depths differ from a host BFS")
        far = max(want, key=lambda k: (want[k], k))
        directed = host_bfs(out_adj, [node.id], len(ids))
        paths = cx.find_paths(PathRequest(from_id=node.id, to_id=far))
        if far in directed:
            p = paths.paths[0]
            check(len(p.edges) == directed[far],
                  "find_paths is not a shortest path")
            check(all(b in out_adj.get(a, ()) for a, b in
                      zip(p.nodes, p.nodes[1:])), "find_paths left the edges")
        else:
            check(not paths.paths, "find_paths found an unreachable node")
    check(cx.traverse(TraversalRequest(start=[sample[0].id], max_depth=3,
                                       direction=BOTH)).depths
          == host_bfs(und, [sample[0].id], 3), "traverse (both) differs")
    # the device tiers: G2 through per_anchor, G1 (then G2) in depths_from
    m = cx.mirror
    m.HOST_FRONTIER_BUDGET = 0
    lat.clear()
    check([results_key(r) for r in run_all(und, "relaxation tier")]
          == [results_key(r) for r in before],
          "the relaxation tier differs from the host tier")
    relax_ms = statistics.median(lat)
    relax = _wrappers()["bfs_relax"]
    for node in [n for n in sample if len(und.get(n.id, ())) >= 2][:10]:
        want = host_bfs(und, [node.id], 3)
        check(m.depths_from([node.id], 3) == want,
              "depths_from (G1) differs from a host BFS")
        m.DEVICE_FRONTIER_CAP = 1
        launched = relax.launches
        check(m.depths_from([node.id], 3) == want,
              "depths_from (G1 overflow, then G2) differs")
        check(relax.launches == launched + 1, "G1 did not overflow into G2")
        m.DEVICE_FRONTIER_CAP = type(m).DEVICE_FRONTIER_CAP
    m.HOST_FRONTIER_BUDGET = type(m).HOST_FRONTIER_BUDGET
    with uncounted():                 # G1 and G2 at the main path's shapes
        import torch
        from cortex_tpu_torch.ops.graph_bfs import INF_DEPTH
        m.ensure()
        rows = [m._row_of[n.id] for n in sample if n.id in m._row_of]
        for r in rows[:10]:
            anchor = torch.tensor([r], dtype=torch.int32, device=dev)
            for cap in (1, m.DEVICE_FRONTIER_CAP):
                gc.walk(m._nbrs, anchor, 3, cap)
        dist0 = torch.full((2, m._nbrs.shape[0]), INF_DEPTH,
                           dtype=torch.int32, device=dev)
        dist0[0, rows[0]] = dist0[1, rows[1]] = 0
        for hops in (1, 3):
            gc.relax(m._nbrs, dist0, hops)
            gc.relax(m._nbrs, dist0[:1].contiguous(), hops)
    # delete_edge: an anchor's edge goes, the oracle without it agrees
    anchor = queries[1][1][0]
    gone = next(e for e in edges if anchor in (e.from_id, e.to_id))
    check(cx.delete_edge(gone.id), "delete_edge failed")
    edges = [e for e in edges if e.id != gone.id]
    und, out_adj = adjacency(edges)
    after_delete = run_all(und, "after delete_edge")
    cx.close()
    t0 = time.monotonic()
    cx = Cortex.open(path, CortexConfig(), device=dev)
    co = cx.index._corpus
    for j, (old, new) in enumerate(zip(after_delete,
                                       run_all(und, "after reopen"))):
        same_hybrid(as_oracle(old), new, f"across the reopen, query {j}")
    t_reopen = time.monotonic() - t0
    cx.close()
    say("8-cortex-graph", nodes=len(ids), edges=len(edges) + 1,
        create_edge_s=t_edges, search_hybrid_ms_p50={
            "host_tier": host_ms, "relaxation_tier": relax_ms},
        queries=len(queries), changed_by_delete=sum(
            results_key(a) != results_key(b)
            for a, b in zip(before, after_delete)),
        reopen_and_search_s=t_reopen, graph_cases=gc.cases,
        graph_max_abs_err=gc.max_abs_err, card=card)


# ------------------------------------------------------------ --profile


def profile_layers(name, index, q_np, q_lat):
    """Trace PROFILE_ROUNDS searches of index `name` at batch 64 and at
    batch 1. Spans:
    L0 search_batch (the whole search), L1 sync and filter codes, L2
    dispatch (enqueue only; the fetch that waits for the device lies
    between L2 and L4), L4 host exact re-rank and id map. Device time
    sums the kernels' own rows (a span's device-side range is left out:
    it covers the kernels it launched), so the idle share is
    1 - busy / wall."""
    from pathlib import Path
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    import torch
    co = index._corpus

    def span(name, fn):
        def wrapped(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return wrapped

    spans = {"L1.sync": "sync", "L1.filter_codes": "_filter_codes",
             "L2.dispatch": "_dispatch_search", "L4.rerank_host": "_finish_topk"}
    for span_name, attr in spans.items():
        setattr(co, attr, span(span_name, getattr(co, attr)))
    spans["L0.search_batch"] = None
    out_dir = Path(__file__).resolve().parent / "profile_out"
    out_dir.mkdir(exist_ok=True)
    for label, batches in (("batch64", [q_np] * PROFILE_ROUNDS),
                           ("batch1", [q_lat[b:b + 1]
                                       for b in range(PROFILE_ROUNDS)])):
        for q in batches[:3]:
            index.search_batch(q, K)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for q in batches:
                with record_function("L0.search_batch"):
                    index.search_batch(q, K)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / len(batches)
        host, dev = {}, {}
        for e in prof.key_averages():
            if e.key in spans:
                if e.device_type != DeviceType.CUDA:
                    host[e.key] = e.cpu_time_total / 1e3 / len(batches)
            elif e.device_type == DeviceType.CUDA:
                dev[e.key[:80]] = e.self_device_time_total / 1e3 / len(
                    batches)
        busy = sum(dev.values())
        say(f"profile-{name}-{label}", rounds=len(batches),
            traced_wall_ms=wall, device_busy_ms=busy,
            device_idle_share=1 - busy / wall, host_ms=host,
            device_ms=dict(sorted(dev.items(), key=lambda kv: -kv[1])[:8]))
        prof.export_chrome_trace(str(out_dir / f"trace_{name}_{label}.json"))


def profile_index(name, index, q_np, q_lat, card):
    """--profile for one index: untraced search speed, then the traces."""
    qps, p50, p99 = search_speed(index, q_np, q_lat)
    say(f"profile-{name}-speed", batch64_qps_median=statistics.median(qps),
        batch64_qps_runs=qps, batch1_ms_p50=p50, batch1_ms_p99=p99,
        batch1_queries=len(q_lat), card=card)
    profile_layers(name, index, q_np, q_lat)


def build_variants(macro, values, source="flat_scan.cu"):
    """csrc/<source> alone as plain-C libraries, one for each value of
    the compile-time switch `macro`, one nvcc each, side by side.
    Returns ({value: ctypes.CDLL}, {value: nvcc wall seconds})."""
    import ctypes
    import subprocess
    from cortex_tpu_torch.ops import build
    src = build._CSRC / source
    out = build._BUILD / f"{src.stem}_variants"
    out.mkdir(parents=True, exist_ok=True)
    logs = {n: out / f"{macro}_{n}.log" for n in values}
    t0 = time.perf_counter()
    procs = {}
    for n in values:
        with open(logs[n], "w") as log:
            procs[n] = subprocess.Popen(
                [build._nvcc(), *build._NVCC_FLAGS, "-shared",
                 f"-I{build._CSRC}", f"-D{macro}={n}", str(src), "-o",
                 str(out / f"{macro}_{n}.so")],
                stdout=log, stderr=subprocess.STDOUT)
    secs = {}
    while len(secs) < len(procs):
        for n, p in procs.items():
            if n not in secs and p.poll() is not None:
                secs[n] = time.perf_counter() - t0
        time.sleep(0.05)
    for n, p in procs.items():
        check(p.returncode == 0,
              f"nvcc failed on {macro}={n}:\n{logs[n].read_text()}")
    return ({n: ctypes.CDLL(str(out / f"{macro}_{n}.so")) for n in procs},
            secs)


def profile_k1_parts(index, q_np, card):
    """K1's kernel alone (no merge) at the flat index's 1M x 768 planes,
    at batch 64 and 1 and cand 64 and 2048: whole, and cut short after
    the int8 product and after epilogue 1 (descale and threshold filter
    into the score tile); then whole again on the same planes rolled so
    that the rows the index has not used yet (masked, at the start)
    come last. In the cut kernels the thresholds never rise, so epilogue
    1 does the exact division for every score: its share is an upper
    bound."""
    import ctypes
    import torch
    from cortex_tpu_torch.ops import similarity as sim

    class Plan(ctypes.Structure):                   # flat_scan.cuh
        _fields_ = [(f, ctypes.c_int) for f in (
            "qt", "n_groups", "n_part", "m", "capb", "bufs_global", "smem",
            "aligned")]

    libs, _ = build_variants("CORTEX_K1_PARTS", (0, 1, 2))
    co = index._corpus
    emb_i8, rinv = co._dev_q
    cap, d = emb_i8.shape
    check(d % 16 == 0, "K1 parts are timed on 16-byte rows only")
    dev = emb_i8.device
    bias = torch.where(co._dev[1].bool(), 0.0, -1e30).float()   # live rows
    unused = int(torch.argmax(co._dev[1].int()))    # rows before the first
    planes = (emb_i8, rinv, bias)
    rolled = tuple(torch.roll(t, -unused, 0).contiguous() for t in planes)
    cases = {"whole_ms": (libs[0], planes), "product_ms": (libs[1], planes),
             "product_and_epilogue1_ms": (libs[2], planes),
             "whole_unused_rows_last_ms": (libs[0], rolled)}
    q = torch.from_numpy(q_np).to(dev)
    ptr = ctypes.c_void_p
    stream = ptr(torch.cuda.current_stream().cuda_stream)
    out = {}
    for b in (BATCH, 1):
        qi8, qs = sim.quantize_queries(q[:b])
        for cand in FLAT_CANDS:
            row = {}
            for label, (lib, (e, r, bs)) in cases.items():
                plan = Plan()
                check(lib.cortex_quant_scan_plan(b, cap, d, cand, 1,
                                                 ctypes.byref(plan)) == 0,
                      "K1 parts: no launch shape")
                ov = torch.empty(b, plan.n_part * plan.m, device=dev)
                oi = torch.empty_like(ov, dtype=torch.int32)
                nbuf = (plan.n_groups * plan.n_part * plan.qt * plan.capb
                        if plan.bufs_global else 1)
                bv = torch.empty(nbuf, device=dev)
                bi = torch.empty_like(bv, dtype=torch.int32)
                pub = torch.zeros(plan.n_groups * plan.qt * (plan.n_part + 1),
                                  dtype=torch.int32, device=dev)
                args = [ptr(t.data_ptr()) for t in (
                    e, r, qi8, qs, bs, ov, oi, bv, bi, pub)]

                def run():
                    pub.zero_()
                    check(lib.cortex_quant_scan_launch(
                        ctypes.byref(plan), *args, b, cap, d, cand,
                        stream) == 0, "K1 parts: launch failed")
                row[label] = time_ms(run, 10)
            row["selection_ms"] = (row["whole_ms"]
                                   - row["product_and_epilogue1_ms"])
            out[f"b{b}_cand{cand}"] = row
    say("profile-flat-k1-parts", card=card, unused_rows_first=unused, **out)


def profile_k2_sorts(index, q_np, card):
    """K2 alone at the flat index's fp32 planes on K1's candidates (k 16),
    at batch 64 and 1 and cand 64 to 2048, built with its largest warp
    sort of 64, 256 (the ops' build) and 1,024 entries
    (CORTEX_K2_WARP_SORT_MAX; beyond it the shared-memory sort), with
    each build's nvcc seconds (the three compile side by side). The
    three builds' results must be equal."""
    import ctypes
    import torch
    from cortex_tpu_torch.ops import similarity as sim
    sorts = (64, 256, 1024)
    libs, secs = build_variants("CORTEX_K2_WARP_SORT_MAX", sorts)
    co = index._corpus
    emb = co._dev[0]
    emb_i8, rinv = co._dev_q
    cap, d = emb.shape
    bias = torch.where(co._dev[1].bool(), 0.0, -1e30).float()   # live rows
    q = torch.from_numpy(q_np).to(emb.device)
    qi8, qs = sim.quantize_queries(q)
    ptr = ctypes.c_void_p
    stream = ptr(torch.cuda.current_stream().cuda_stream)
    out = {}
    for cand in (64, 128, 256, 1024, 2048):
        cv, ci = sim.quant_candidates(emb_i8, rinv, qi8, qs, bias, cand)
        cand_p2 = 1 << (cand - 1).bit_length()
        for b in (BATCH, 1):
            ov = torch.empty(b, 16, device=emb.device)
            oi = torch.empty_like(ov, dtype=torch.int32)
            args = [ptr(t.data_ptr()) for t in (emb, q[:b], cv[:b], ci[:b],
                                                ov, oi)]
            row, first = {}, None
            for n in sorts:
                def run():
                    check(libs[n].cortex_quant_rerank_launch(
                        *args, b, cap, d, cand, cand_p2, 16, stream) == 0,
                        "K2 sorts: launch failed")
                row[f"warp_sort_max_{n}_ms"] = time_ms(run, 20)
                run()
                got = (ov.clone(), oi.clone())
                if first is None:
                    first = got
                check(torch.equal(got[0], first[0])
                      and torch.equal(got[1], first[1]),
                      f"K2 sorts: builds differ at cand {cand}, batch {b}")
            out[f"b{b}_cand{cand}"] = row
    say("profile-flat-k2-sorts", card=card, nvcc_s=secs, **out)


def profile_relax_variants(dev, gen, card):
    """G2 alone (csrc/graph_bfs.cu) at phase 2's 10M x 64 table, 1 and 8
    anchors, 3 rounds: whole (CORTEX_RELAX_PARTS = 0, whose results must
    equal the ops') and cut after the table read (1: no gathers, the
    table's entries stand in for the depths)."""
    import ctypes
    import torch
    from cortex_tpu_torch.ops import graph_bfs as g
    parts, _ = build_variants("CORTEX_RELAX_PARTS", (0, 1), "graph_bfs.cu")
    libs = {"whole": parts[0], "table_read_only": parts[1]}
    nb = graph_table(dev, gen, GRAPH_ROWS, GRAPH_DEG, GRAPH_MEAN_DEG,
                     GRAPH_HUBS)
    n, d = nb.shape
    rounds = 3
    ptr = ctypes.c_void_p
    stream = ptr(torch.cuda.current_stream().cuda_stream)
    out = {}
    for a in (1, 8):
        anc = torch.randint(0, n, (a,), dtype=torch.int32, device=dev,
                            generator=gen)
        dist0 = sources(dev, anc, n)
        want = g.bfs_relax(nb, dist0, rounds)
        res = torch.empty_like(dist0)
        work = torch.empty(2 * n * (1 if a == 1 else 8 * -(-a // 8)),
                           dtype=torch.int32, device=dev)
        row = {}
        for name, lib in libs.items():
            def run(lib=lib):
                check(lib.cortex_bfs_relax_launch(
                    ptr(nb.data_ptr()), n, d, 1, ptr(dist0.data_ptr()), a,
                    rounds, ptr(res.data_ptr()), ptr(work.data_ptr()),
                    stream) == 0, "relax variants: launch failed")
            row[f"{name}_ms"] = time_ms(run, 5)
            if name == "whole":
                run()
                check(torch.equal(res, want),
                      f"relax variant {name} differs from the ops' G2")
        out[f"a{a}_r{rounds}"] = row
    say("profile-graph-relax-variants", card=card, **out)


# ------------------------------------------------------------ main


def check_no_reference_import():
    """Fail if any module of the JAX package was imported."""
    loaded = sorted(m for m, v in sys.modules.items() if v is not None and (
        m == "cortex_tpu" or m.startswith("cortex_tpu.")))
    check(not loaded, f"the JAX package was imported: {loaded[:5]}")


def main(argv) -> int:
    import torch
    if argv not in ([], ["--profile"]):
        print(f"usage: chip_smoke.py [--profile]; got {argv}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from cortex_tpu_torch import native
    from cortex_tpu_torch.ops import build
    from cortex_tpu_torch.utils.device import card_identity, resolve_device

    torch.backends.cuda.matmul.allow_tf32 = False     # exact fp32 oracle
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device("cuda")
    card = card_identity()
    t0 = time.monotonic()
    lib = build.build_library()
    build.load_ops()
    say("1-build", seconds=time.monotonic() - t0, library=str(lib),
        torch=torch.__version__, cuda=torch.version.cuda, card=card,
        native_rerank=native.available())

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    kc, fc = KernelCheck(), FlatKernelCheck()
    if argv == ["--profile"]:
        index, q_np, q_lat, _, rows = phase_index(dev, N_BIG, D_BIG, gen,
                                                  kc)
        profile_index("ivf", index, q_np, q_lat, card)
        del index
        torch.cuda.empty_cache()
        index, _ = phase_flat_build(dev, rows, fc)
        profile_index("flat", index, q_np, q_lat, card)
        profile_k1_parts(index, q_np, card)
        profile_k2_sorts(index, q_np, card)
        profile_hybrid(dev, index, (None, *rows[1:3], None, rows[4]), card)
        del index, rows
        torch.cuda.empty_cache()
        profile_relax_variants(dev, gen, card)
        check_no_reference_import()
        print(card, flush=True)
        return 0
    check_synthetic(kc, dev, gen, 16, 37, 100, 5, 3)        # small, odd
    check_synthetic(kc, dev, gen, 144, 192, 384, BATCH, 18)  # phase 4's
    check_flat_synthetic(fc, dev, gen, 3001, 37, 5)          # small, odd
    check_flat_synthetic(fc, dev, gen, 32768, 384, BATCH)    # phase 6's
    gc = GraphKernelCheck()
    check_graph_small(gc, dev, gen)
    say("2-kernel-small", cases=kc.cases, max_abs_err=kc.max_abs_err,
        flat_cases=fc.cases, k1_max_abs_err=fc.k1_err,
        k2_max_abs_err=fc.k2_err, graph_cases=gc.cases,
        graph_overflows=gc.overflows, graph_max_abs_err=gc.max_abs_err)
    graph_perf = check_graph_big(gc, dev, gen, card)
    torch.cuda.empty_cache()
    index, q_np, q_lat, ivf_perf, rows = phase_index(dev, N_BIG, D_BIG,
                                                     gen, kc)
    perf = {"probed_scores": ivf_perf, **graph_perf}

    reset_launches()                          # the IVF main path
    phase_search(index, q_np, q_lat, gen, dev, card)
    del index
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as workdir:
        phase_cortex(dev, workdir)
    launches = {"probed_scores": launch_counts()["probed_scores"]}

    index, flat_perf = phase_flat_build(dev, rows, fc)
    perf.update(flat_perf)
    rows = (None, *rows[1:3], None, rows[4])   # phase 7: ids, kinds, member
    reset_launches()                          # the flat main path
    phase_flat_search(index, q_np, q_lat, gen, dev, card)
    reset_launches(["frontier_bfs", "frontier_bfs_compact",
                    "bfs_relax"])                 # the graph main path
    phase_hybrid(dev, index, rows, gc, card)
    del index, rows
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as workdir:
        phase_cortex_flat(dev, workdir)
        phase_cortex_graph(dev, workdir, gc, card)
    counts = launch_counts()
    launches.update({name: counts[name] for name in (
        "quant_candidates", "quant_rerank", "frontier_bfs",
        "frontier_bfs_compact", "bfs_relax")})
    for name, n in launches.items():
        check(n > 0, f"the main path never launched {name}")

    errs = {"probed_scores": kc.max_abs_err, "quant_candidates": fc.k1_err,
            "quant_rerank": fc.k2_err, **gc.max_abs_err}
    main_shapes = {"probed_scores": (f"b{BATCH}", "b1"),
                   "quant_candidates": (f"b{BATCH}_cand{FLAT_CANDS[0]}",
                                        f"b1_cand{FLAT_CANDS[0]}"),
                   "quant_rerank": (f"b{BATCH}", "b1"),
                   "frontier_bfs": ("a1_h3", None),
                   "frontier_bfs_compact": ("a1_h3", None),
                   "bfs_relax": ("a1_r3", None)}
    say("2-bounds", card=card, **{
        name: {shape: {k: t[k] for k in ("ms", "bound_ms", "bound_by",
                                          "share_of_bound")}
               for shape, t in perf[name].items()}
        for name in KERNELS})
    check_no_reference_import()
    kernels = []
    for name, (src, repl) in KERNELS.items():
        head, second = main_shapes[name]
        t = perf[name][head]
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "shape": head}
        if second is not None:
            entry["batch1"] = perf[name][second]
        entry.update({k: v for k, v in perf[name].items()
                      if k not in main_shapes[name]})
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
