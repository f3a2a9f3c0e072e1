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
     through the op alone (op_ms). K1 and K2 also at the linker's shape
     (b128, cand 256, k 128) and dedup's (b256, cand 128, k 64) on the
     1M x 768 planes. The decay sweep (D1) at 1, 31 and 65,537 edges and
     at 10,000,000 (config #5's scale, made on the card; days <= 0,
     exempt rows, importance * shield = 1, rows exactly on each
     threshold): new_w and its masks bit-equal to the plain version;
     its and the plain version's times at 10M and at the engine's 1M
     chunk beside the bound in bytes (20 B an edge). The text encoder's
     residual + LayerNorm (E1) at h 36, 384 and 768 and its masked
     attention (E2) at (B 5, H 3, dh 32), BGE-small's (H 12, dh 32) and
     dh 64, each at S 1, 31, 128 and 512 and at E2's tile edges (S 63,
     64, 65, 127, 129) with padded rows, at the mask patterns of
     kept_patterns (kept keys ending on and one past a tile edge, masked
     keys in front and in the middle, a wholly masked tile between two
     kept ones, only the last key kept) and at dh 64, S 512, B * H 3,072
     (E1 also with the embedding's [S, h] residual): within LN_ATOL and
     ATTN_ATOL of the plain versions, and E2's kept rows bit-equal after
     new values at every masked key; E2 with |q| and |k| 10x larger,
     where the plain fp32 version is itself further than ATTN_ATOL from
     the float64 answer: no further from it than the plain version plus
     ATTN_ATOL. Then the times of each, its plain version and one
     PyTorch call computing the same function (F.layer_norm on the
     pre-summed input, scaled_dot_product_attention with the mask bias)
     at ENC_TIMED (E2 also at ENC_MIX: the S 512 chunk with phase 11's
     lengths and with every key kept)
     over input sets that together exceed the L2 four times (so read
     from HBM), beside the bound (E1: bytes; E2: bytes or fp32 FLOPs of
     the kept keys, the larger, and beside it the bound of its route:
     3 TF32 products per fp32 product at 495 TFLOP/s);
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
     the mirror's table, delete_edge, and the same after a reopen;
  9. the auto-linker at the north star's scale, run between phases 7
     and 6 on phase 5's flat index and phase 7's 1M light nodes: an
     AutoLinker built as Cortex builds it, the cursor advanced past the
     1M nodes, then 10,000 new nodes (noisy copies of phase-3 rows at
     cosine 0.70-0.99, an hour apart, agents from a pool of 1,000) in 20
     batches of 500 through put_nodes_batch, one run_cycle after each;
     the cursor ends at the last node with nothing past it, every node
     is in the index without a regrow, every similarity edge weighs its
     rows' exact cosine, and the first cycle's candidate lists equal
     K1's and K2's plain versions' (near-ties aside) at recall@100 >=
     0.99 against the exact oracle; cycle wall, ms in each linker.*
     span, auto-link pairs/s and edges/s;
 10. the decay sweep at config #5: DecayEngine._sweep_arrays over 10M
     edges from host arrays in 1M chunks (H2D, D1, D2H) against
     decay_sweep_host on the same arrays; apply_decay on a SQLite store
     of 1M edges (config #5's 10M cut for time), in process and through
     the worker process on a byte copy, each against a numpy oracle
     (weights, deletions, audit rows, counts); then on phase 8's store
     Cortex.bulk_import of 1,000 nodes (advance_linker_cursor, never
     linked) and 1,000 through store_batch with run_linker_cycle until
     the backlog is 0, and the cursor across a reopen;
 11. the text encoder at the full BGE-small-en-v1.5 width (vocab
     30,522, hidden 384, 12 layers of 12 heads, intermediate 1,536, 512
     positions, CLS pooling; seeded random weights written with the
     port's init_params + save_npz and a made-up 30,522-entry WordPiece
     vocabulary): the card's forward against the CPU's on 24 texts, texts
     alone against them in a mixed batch; then Cortex with model =
     "flax:<npz>" on SQLite, on the flat index (K1 + K2) and on the IVF
     index (every list probed; the same weights with mean pooling):
     bulk_import of 20,000 nodes (25-100 tokens, 5 % truncated at 512,
     so nearly every chunk pads to 512), 200 single stores, 1,000 text
     searches held to the exact fp32 oracle over the stored embeddings
     (same_hits), the spread of their pairwise cosines, the oracle's
     score gaps, and same_hits rejecting, in every search, the oracle's
     list with its rank 1 lost; then the embedder's forward (embed_tokens,
     in embed_batch's chunks) at B 1, 64 and 4,096 and S 32, 128 and 512
     (ms, texts/s, fp32 FLOP/s against 67 TFLOP/s) and one
     torch.profiler trace of a forward at B 64, S 128, at the S 512
     chunk with every key kept and at the S 512 chunk with phase 11's
     lengths: the shares of the products, E1, E2 and GELU in its device
     time.

Five main paths: phases 3-4 (IVF), 5-6 (flat), 7-8 (graph, on the
flat index), 9-10 (the linker) and 11 (the encoder). Every launch count
is set to 0 just before each and read just after it: probed_scores from
the first and fifth, quant_candidates and quant_rerank from the second
to fifth, frontier_bfs, frontier_bfs_compact and bfs_relax from the
third, decay_sweep from the fourth, add_layer_norm and masked_attention
from the fifth; launches made in phase 2, or to compare a kernel with
its plain version (or to time the forward) in phases 7-9 and 11, do not
count. The line
before the last lists the kernels as JSON (launches per path beside
their sum), the line before that the card's name and power limit; the
last line is the device JSON. At the end the script fails if any
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
import itertools
import json
import logging
import os
import statistics
import sys
import tempfile
import time
from dataclasses import replace

import numpy as np

D_BIG, N_BIG, BATCH, K = 768, 1_000_000, 64, 10
N_NODES, DIM_NODES = 20_000, 384
QPS_RUNS, QPS_ROUNDS, N_LAT = 5, 30, 1000
PROFILE_ROUNDS = 20
HBM_BYTES_PER_S = 3.35e12       # H100 SXM peaks, NVIDIA's data sheet
INT8_OPS_PER_S = 1.979e15       # dense int8 tensor cores
F32_OPS_PER_S = 67e12           # fp32 outside the tensor cores
TF32_OPS_PER_S = 495e12         # dense TF32 tensor cores
SPIN_CYCLES_PER_S = 2e9         # >= the SM clock (1.98 GHz at boost)
L2_BYTES = 50 << 20             # the H100 SXM's L2 cache
NEAR_TIE = 1e-6          # exact-oracle near-ties that may swap ranks
SCORE_ATOL = 1e-5        # fp32 scores: host re-rank vs device oracle
FLAT_CANDS = (64, 2048)   # k = 10 (k bucket 16) and search_threshold's 1000
GRAPH_ROWS, GRAPH_DEG = 10_000_000, 64   # the 100M-edge tier's table
GRAPH_MEAN_DEG, GRAPH_HUBS = 9.0, 0.001  # ~10 neighbours a row, 0.1 % hubs
GRAPH_CAP, GRAPH_OUT_CAP = 8192, 16384   # DEVICE_FRONTIER_CAP, PACKED_OUT_CAP
HYB_EDGES, HYB_LIMIT, HYB_HOPS = 5_000_000, 17, 2    # BASELINE config #4
HYB_QUERIES, HYB_LAT = 48, 300
CX_EDGES = 10_000
LINKER_SHAPES = ((128, 256, 128), (256, 128, 64))  # (B, cand, k): linker, dedup
DECAY_EDGES, DECAY_CHUNK = 10_000_000, 1_000_000    # config #5; CHUNK
DECAY_STORE_EDGES, DECAY_STORE_NODES = 1_000_000, 100_000
DECAY = dict(daily_rate=0.01, shield=0.8, delete_threshold=0.05,
             prune_threshold=0.1)                   # DecayConfig()
DECAY_BYTES_PER_EDGE = 20   # 13 in (3 f32 + a bool), 7 out (f32 + 3 bools)
DECAY_OPS_PER_EDGE = 12     # f32 mul, sub, max, neg, exp, compares, selects
# D1 against decay_sweep_host: each exp within 2 ulps of the exact value
# (expf's documented bound; numpy's float32 exp measured so on the CPU
# tests' inputs), then the product rounded once: 5 * 2^-23 apart
# relative, which is up to 10 ulps of a product low in its binade
HOST_ULPS = 10
STREAM_NODES, STREAM_BATCH, STREAM_AGENTS = 10_000, 500, 1000
STREAM_EDGE_BUDGET = 50_000
CX_IMPORT, CX_STREAM = 1000, 1000
ENC_EPS = 1e-12                  # BGE-small-en-v1.5's layer_norm_eps
# E1 against plain: the mean's and variance's sums added in another order
# (outputs ~N(0, 1) * g + b); E2 against plain: online softmax with
# __expf and sums in another order (outputs: averages of N(0, 1) values)
LN_ATOL, ATTN_ATOL = 1e-5, 1e-5
ENC_ATOL, ENC_COS = 1e-4, 0.99999   # the card's forward against the CPU's
ENC_CHECK_SEQS = (1, 31, 128, 512)
ATTN_TILE = 32                           # E2's key tile (encoder_attn.cu)
ENC_EDGE_SEQS = (63, 64, 65, 127, 129)   # about E2's key tile edges
ENC_ATTN_BIG = (256, 12, 512, 64)        # B, H, S, dh: B * H 3,072
# |q| and |k| ENC_ATTN_SCALE times the other cases': scores of std ~100,
# where the plain fp32 version is itself ~1e-4 from the float64 answer
ENC_ATTN_SCALE = 10.0
ENC_TIMED = {            # name -> (B, S, h, heads) of a timed E1 / E2 call
    "b64_s128": (64, 128, 384, 12),
    "b1_s32": (1, 32, 384, 12),            # a store or a search
    "chunk_s512": (195, 512, 384, 12),     # chunk_rows(512): bulk_import
    "dh64_b64_s128": (64, 128, 768, 12)}   # BGE-base's head width
# E2 also at the S 512 chunk with phase 11's lengths (encoder_nodes: most
# rows keep U(25, 100) keys, ENC_LONG of them all 512) and with every key
# kept (as encoder_speed runs it): name -> (B, S, h, heads, attn_mask kind)
ENC_MIX = {"chunk_s512_mix": (195, 512, 384, 12, "mix"),
           "chunk_s512_all": (195, 512, 384, 12, "all")}
ENC_MIX_KEYS = (25, 100)
ENC_NODES, ENC_STORES, ENC_SEARCHES = 20_000, 200, 1_000
ENC_WORDS, ENC_TOPICS, ENC_LONG, ENC_SEED = 20_000, 500, 0.05, 8
ENC_KINDS = ("fact", "event", "decision", "goal", "observation")
ENC_SAMPLE = 24
ENC_SPEED_BATCHES, ENC_SPEED_SEQS = (1, 64, 4096), (32, 128, 512)
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
    "decay_sweep": ("cortex_tpu_torch/csrc/decay_sweep.cu",
                    "cortex_tpu/ops/decay.py:28"),
    "add_layer_norm": ("cortex_tpu_torch/csrc/encoder_rows.cu",
                       "cortex_tpu/models/encoder.py:200"),
    "masked_attention": ("cortex_tpu_torch/csrc/encoder_attn.cu",
                         "cortex_tpu/models/encoder.py:216"),
}


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def say(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def _wrappers():
    from cortex_tpu_torch.ops import (decay, encoder, graph_bfs, ivf_gather,
                                      similarity)
    return {"probed_scores": ivf_gather.probed_scores,
            "quant_candidates": similarity.quant_candidates,
            "quant_rerank": similarity.quant_rerank,
            "frontier_bfs": graph_bfs.frontier_bfs,
            "frontier_bfs_compact": graph_bfs.frontier_bfs_compact,
            "bfs_relax": graph_bfs.bfs_relax,
            "decay_sweep": decay.decay_sweep,
            "add_layer_norm": encoder.add_layer_norm,
            "masked_attention": encoder.masked_attention}


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
    for b, cand, k in LINKER_SHAPES:          # the linker's and dedup's
        qb = linker_queries(co, b, seed=b)
        qib, qsb = sim.quantize_queries(qb)
        for bias in biases[:2]:
            cv, ci = fc.k1(emb_i8, rinv, qib, qsb, bias, cand)
            fc.k2(emb, qb, cv, ci, k)
        nbytes = cap * d + 8 * cap + b * d + 4 * b + 8 * b * cand
        out["quant_candidates"][f"b{b}_cand{cand}"] = timing(
            time_ms(lambda: sim.quant_candidates(emb_i8, rinv, qib, qsb, b0,
                                                 cand), 10),
            time_ms(lambda: sim.quant_candidates_plain(
                emb_i8, rinv, qib, qsb, b0, cand), 5),
            bound_ms(nbytes, 2 * b * cap * d, INT8_OPS_PER_S))
        cv, ci = sim.quant_candidates(emb_i8, rinv, qib, qsb, b0, cand)
        valid = int((cv > -1e29).sum())
        nbytes = 4 * valid * d + 4 * b * d + 8 * cv.numel() + 8 * b * k
        out["quant_rerank"][f"b{b}_cand{cand}_k{k}"] = timing(
            time_ms(lambda: sim.quant_rerank(emb, qb, cv, ci, k), 50),
            time_ms(lambda: sim.quant_rerank_plain(emb, qb, cv, ci, k), 20),
            bound_ms(nbytes, 2 * valid * d, F32_OPS_PER_S))
    say("2-flat-kernels-1M", cands=list(FLAT_CANDS),
        linker_shapes=[list(t) for t in LINKER_SHAPES], cases=fc.cases,
        k1_max_abs_err=fc.k1_err, k2_max_abs_err=fc.k2_err, **out)
    return out


def linker_queries(co, b, seed):
    """b unit queries on the card, each a noisy copy (cosine ~0.85) of
    a random row of the flat index's host mirror."""
    import torch
    rng = np.random.default_rng(seed)
    live = np.flatnonzero(co._live_h)
    x = co._emb_h[rng.choice(live, b, replace=False)]
    q = x + 0.62 * rng.standard_normal(x.shape).astype(np.float32) / \
        x.shape[1] ** 0.5
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return torch.from_numpy(q.astype(np.float32)).to(co._device)


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
    # a millisecond apart, as a store written over ~17 minutes: phase 9's
    # linker pages by (created_at, id), and a page boundary inside one
    # shared timestamp would list every node that holds it
    t_first = time.time() - 3 * 86400.0
    storage.put_nodes_batch(
        Node(id=i, kind=k, title=i, body="", source=agent,
             created_at=t_first + j * 1e-3, updated_at=t_first + j * 1e-3)
        for j, (i, k) in enumerate(zip(ids, kinds)))
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
    latency of both tiers, split by leg. Returns the MemoryStorage of
    1M light nodes (phase 9 links into it)."""
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
    return storage


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


# ------------------------------------------------- phase 2, the decay sweep


def f32_ulps(a, b):
    """|a - b| in float32 ulps, elementwise, for non-negative float32
    arrays (numpy)."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


class DecayCheck:
    """D1 against decay_sweep_plain on the same card: new_w and the three
    masks bit-equal (the kernel spells the plain version's operations
    with __fmul_rn / __fsub_rn and calls expf, as torch's exp does on
    the card). max_abs_err must stay 0.0."""

    def __init__(self):
        self.max_abs_err = 0.0
        self.cases = 0

    def compare(self, args):
        import torch
        from cortex_tpu_torch.ops import decay
        got = decay.decay_sweep(*args, **DECAY)
        want = decay.decay_sweep_plain(*args, *(
            float(np.float32(v)) for v in DECAY.values()))
        torch.cuda.synchronize()
        err = float((got[0] - want[0]).abs().max()) if args[0].numel() \
            else 0.0
        check(torch.equal(got[0], want[0]),
              f"D1 new_w differs from plain by up to {err}")
        for name, g, w in zip(("delete", "prune", "changed"), got[1:],
                              want[1:]):
            check(g.dtype == torch.bool and torch.equal(g, w),
                  f"D1 {name} mask differs from plain")
        self.max_abs_err = max(self.max_abs_err, err)
        self.cases += 1
        return got


def decay_inputs(dev, gen, n):
    """Seeded edges on the card: days in [-5, 400) (a few exactly 0),
    10 % exempt, importance * shield = 1 on every 13th row (importance
    1.25 at shield 0.8: no decay), and rows exactly on each threshold
    (days 1e-6: exp rounds to 1)."""
    import torch
    w = torch.rand(n, device=dev, generator=gen)
    days = torch.rand(n, device=dev, generator=gen) * 405.0 - 5.0
    imp = torch.rand(n, device=dev, generator=gen)
    exempt = torch.rand(n, device=dev, generator=gen) < 0.1
    days[::97] = 0.0
    imp[3::13] = 1.25
    for j, thr in enumerate((DECAY["delete_threshold"],
                             DECAY["prune_threshold"])):
        w[j::11] = thr
        days[j::11] = 1e-6
    return w, days, imp, exempt


def check_decay(dc, dev, gen, card):
    """Phase 2 for D1: small odd sizes, then DECAY_EDGES (config #5's
    10M) made on the card, and the kernel's and plain version's times
    there and at the engine's DECAY_CHUNK (1M) beside the bound in bytes
    (DECAY_BYTES_PER_EDGE an edge over 3.35 TB/s)."""
    import torch
    for n in (1, 31, 65_537):
        dc.compare(decay_inputs(dev, gen, n))
    args = decay_inputs(dev, gen, DECAY_EDGES)
    got = dc.compare(args)
    flags = {k: int(t.sum()) for k, t in zip(("delete", "prune", "changed"),
                                             got[1:])}
    check(all(flags.values()), f"the 10M sweep raised no flag: {flags}")
    from cortex_tpu_torch.ops import decay
    plain_args = (*args, *(float(np.float32(v)) for v in DECAY.values()))
    perf = {}
    for name, n in (("e10M", DECAY_EDGES), ("e1M", DECAY_CHUNK)):
        a = [t[:n] for t in args]
        pa = (*a, *plain_args[4:])
        perf[name] = timing(
            time_ms(lambda: decay.decay_sweep(*a, **DECAY), 20),
            time_ms(lambda: decay.decay_sweep_plain(*pa), 5),
            bound_ms(DECAY_BYTES_PER_EDGE * n, DECAY_OPS_PER_EDGE * n,
                     F32_OPS_PER_S))
    say("2-decay", cases=dc.cases, max_abs_err=dc.max_abs_err,
        edges=DECAY_EDGES, flags=flags, card=card, **perf)
    del args, got
    torch.cuda.empty_cache()
    return perf


# ------------------------------------------------------ phase 2, encoder


class EncoderKernelCheck:
    """E1 and E2 against their plain versions on the same card, within
    LN_ATOL and ATTN_ATOL; keeps the largest difference of each, and
    checks E2's padding invariance bit for bit. E2 at large |q| and |k|
    is held to the float64 answer instead (e2_scaled)."""

    def __init__(self):
        self.e1_err = self.e2_err = 0.0
        self.e1_cases = self.e2_cases = self.invariant_rows = 0
        self.scaled = []

    def e1(self, x, r, g, b):
        import torch
        from cortex_tpu_torch.ops import encoder as enc
        got = enc.add_layer_norm(x, r, g, b, ENC_EPS)
        want = enc.add_layer_norm_plain(x, r, g, b, ENC_EPS)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(err <= LN_ATOL, f"E1 differs from plain by {err}")
        self.e1_err = max(self.e1_err, err)
        self.e1_cases += 1

    def e2(self, q, k, v, bias, kept):
        """Kernel against plain, then new values at every masked key
        position: no output of a kept row (a query at a kept position)
        may change, bit for bit."""
        import torch
        from cortex_tpu_torch.ops import encoder as enc
        got = enc.masked_attention(q, k, v, bias)
        want = enc.masked_attention_plain(q, k, v, bias)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(err <= ATTN_ATOL, f"E2 differs from plain by {err} at "
              f"{tuple(q.shape)}")
        masked = (~kept)[:, None, :, None]
        again = enc.masked_attention(*(
            torch.where(masked, torch.randn_like(t) * 7.0, t)
            for t in (q, k, v)), bias)
        pos = kept[:, None, :, None].expand_as(got)
        check(torch.equal(got[pos], again[pos]),
              "E2: a masked key changed a kept row")
        self.invariant_rows += int(kept.sum())
        self.e2_err = max(self.e2_err, err)
        self.e2_cases += 1

    def e2_scaled(self, q, k, v, bias):
        """E2 where the plain fp32 version's own error exceeds ATTN_ATOL:
        the kernel and the plain version against the plain version in
        float64; the kernel may be no further from it than the plain
        version plus ATTN_ATOL."""
        import torch
        from cortex_tpu_torch.ops import encoder as enc
        got = enc.masked_attention(q, k, v, bias)
        want = enc.masked_attention_plain(q, k, v, bias)
        exact = enc.masked_attention_plain(
            *(t.double() for t in (q, k, v, bias)))
        torch.cuda.synchronize()
        err = float((got.double() - exact).abs().max())
        plain_err = float((want.double() - exact).abs().max())
        check(err <= plain_err + ATTN_ATOL,
              f"E2 at |q|, |k| x{ENC_ATTN_SCALE}: {err} from the float64 "
              f"answer, the plain fp32 version {plain_err}")
        self.scaled.append({
            "shape": list(q.shape), "err_vs_f64": err,
            "plain_err_vs_f64": plain_err,
            "err_vs_plain": float((got - want).abs().max())})


def ln_inputs(dev, gen, t, h, p):
    """E1's x [t, h], residual [p, h], gain and bias, seeded."""
    import torch
    x = torch.randn(t, h, device=dev, generator=gen) * 3.0 + 0.5
    r = torch.randn(p, h, device=dev, generator=gen)
    g = 1.0 + 0.1 * torch.randn(h, device=dev, generator=gen)
    b = 0.1 * torch.randn(h, device=dev, generator=gen)
    return x, r, g, b


def qkv_views(dev, gen, b, heads, s, dh):
    """E2's q, k and v [B, H, S, dh] as views of one seeded
    [B, S, 3, H, dh] product (the encoder's layout)."""
    import torch
    qkv = torch.randn(b, s, 3, heads, dh, device=dev, generator=gen)
    return tuple(t.transpose(1, 2) for t in qkv.unbind(2))


def kept_patterns(b, s):
    """[b, s] bool: row i keeps the keys of pattern i % 9: all; the first
    64, 65, 128 or 129 (ending on and one past a tile edge of E2); all
    but the first third; all but the keys from S / 4 to S / 2; keys 0-63
    and 128 onwards, with 64-127 (two tiles) wholly masked; only the
    last key."""
    kept = np.zeros((b, s), bool)
    for i in range(b):
        p, row = i % 9, kept[i]
        if p == 0:
            row[:] = True
        elif p in (1, 2, 3, 4):
            row[:(64, 65, 128, 129)[p - 1]] = True
        elif p == 5:
            row[s // 3:] = True
        elif p == 6:
            row[:max(1, s // 4)] = True
            row[s // 2:] = True
        elif p == 7:
            row[:64] = True
            row[128:] = True
        else:
            row[s - 1] = True
    return kept


def attn_mask(dev, gen, b, s, kind):
    """E2's mask bias [B, S] (0 kept, -1e30 masked) and its kept keys
    [B, S] (bool). "uniform": row 0 keeps all S keys, the others their
    first U(1, S); "patterns": kept_patterns; "mix": phase 11's chunk,
    round(ENC_LONG * B) rows keep all S, the others their first
    U(ENC_MIX_KEYS) (the embedder pads a chunk to its longest row);
    "all": every key."""
    import torch
    if kind == "patterns":
        kept = torch.from_numpy(kept_patterns(b, s)).to(dev)
    elif kind == "all":
        kept = torch.ones(b, s, dtype=torch.bool, device=dev)
    else:
        if kind == "uniform":
            lengths = torch.randint(1, s + 1, (b,), device=dev,
                                    generator=gen)
            lengths[0] = s
        else:
            lo, hi = ENC_MIX_KEYS
            lengths = torch.randint(lo, hi + 1, (b,), device=dev,
                                    generator=gen)
            long_rows = torch.randperm(b, device=dev, generator=gen)
            lengths[long_rows[:max(1, round(ENC_LONG * b))]] = s
        kept = torch.arange(s, device=dev)[None, :] < lengths[:, None]
    return torch.where(kept, 0.0, -1e30), kept


def attn_inputs(dev, gen, b, heads, s, dh, kind="uniform", scale=1.0):
    """E2's q, k and v (qkv_views; q and k times `scale`), a mask bias of
    attn_mask's `kind` and its kept keys."""
    q, k, v = qkv_views(dev, gen, b, heads, s, dh)
    if scale != 1.0:
        q, k = q * scale, k * scale
    return (q, k, v, *attn_mask(dev, gen, b, s, kind))


def walked_keys(kept):
    """Keys E2 stages and multiplies for one query row, summed over the
    rows of kept [B, S]: ATTN_TILE for each tile of ATTN_TILE keys that
    holds a kept key (every tile where none does)."""
    import torch
    b, s = kept.shape
    tiles = -(-s // ATTN_TILE)
    pad = torch.zeros(b, tiles * ATTN_TILE, dtype=torch.bool,
                      device=kept.device)
    pad[:, :s] = kept
    walk = pad.view(b, tiles, ATTN_TILE).any(-1)
    walk[~walk.any(-1)] = True
    return int(walk.sum()) * ATTN_TILE


def rotating(make, nbytes):
    """Sets of seeded inputs from make(), each of nbytes, enough that
    together they take 4 * L2_BYTES (one when a set alone does). A timed
    loop that takes them in turn reads its inputs from HBM, as the bound
    assumes; one set that fits in the L2 would stay there across calls
    and be timed below its bound."""
    return [make() for _ in range(max(1, -(-4 * L2_BYTES // nbytes)))]


def time_rotating(fn, sets, reps):
    """time_ms of fn(*set), the sets taken in turn."""
    it = itertools.cycle(sets)
    return time_ms(lambda: fn(*next(it)), reps)


def check_encoder_kernels(ec, dev, gen, card):
    """Phase 2 for E1 and E2: every check case, then the times of the
    kernel, its plain version and one PyTorch call computing the same
    function (F.layer_norm on the pre-summed input; SDPA with the mask
    bias) at ENC_TIMED (E2 also at ENC_MIX), beside the bound: E1's bytes
    (x, r and y once, g and b) over 3.35 TB/s; E2's bytes (q, k, v, ctx
    and the mask) or its fp32 FLOPs (2 * dh for the score and 2 * dh for
    the context, a query and kept key) over 67 TFLOP/s, whichever is
    larger; and E2's route's bound, the same with 3 TF32 FLOPs for each
    fp32 FLOP at 495 TFLOP/s. Each is timed over `rotating` input sets,
    so that it reads them from HBM."""
    import torch
    import torch.nn.functional as F
    from cortex_tpu_torch.ops import encoder as enc
    for h in (36, 384, 768):                    # small, BGE-small, dh 64
        for s in ENC_CHECK_SEQS:                # T = 3 * S: 3, 93 odd
            x, r, g, b = ln_inputs(dev, gen, 3 * s, h, 3 * s)
            ec.e1(x, r, g, b)
            ec.e1(x, r[:s], g, b)               # the embedding's [S, h] rows
    for b, heads, dh in ((5, 3, 32), (4, 12, 32), (4, 12, 64)):
        for s in ENC_CHECK_SEQS + ENC_EDGE_SEQS:
            ec.e2(*attn_inputs(dev, gen, b, heads, s, dh))
    for s in (31, 129, 200, 512):
        for dh in (32, 64):
            ec.e2(*attn_inputs(dev, gen, 9, 4, s, dh, "patterns"))
    ec.e2(*attn_inputs(dev, gen, *ENC_ATTN_BIG))
    torch.cuda.empty_cache()
    for b, heads, s, dh, kind in ((4, 12, 128, 32, "uniform"),
                                  (9, 12, 512, 64, "patterns")):
        ec.e2_scaled(*attn_inputs(dev, gen, b, heads, s, dh, kind,
                                  ENC_ATTN_SCALE)[:4])
    perf = {"add_layer_norm": {}, "masked_attention": {}}
    for name, (b, s, h, heads, kind) in ENC_MIX.items():
        perf["masked_attention"][name] = time_attention(
            dev, gen, b, s, h, heads, kind)
    for name, (b, s, h, heads) in ENC_TIMED.items():
        t, dh = b * s, h // heads

        def ln_set():
            x, r, g, bb = ln_inputs(dev, gen, t, h, t)
            return x, r, g, bb, x + r
        sets = rotating(ln_set, 4 * 3 * t * h)
        perf["add_layer_norm"][name] = timing(
            time_rotating(lambda x, r, g, bb, _: enc.add_layer_norm(
                x, r, g, bb, ENC_EPS), sets, 50),
            time_rotating(lambda x, r, g, bb, _: enc.add_layer_norm_plain(
                x, r, g, bb, ENC_EPS), sets, 20),
            bound_ms(4 * (3 * t * h + 2 * h), 8 * t * h, F32_OPS_PER_S),
            library_ms=time_rotating(lambda x, r, g, bb, xr: F.layer_norm(
                xr, (h,), g, bb, ENC_EPS), sets, 50),
            shape=[t, h], input_sets=len(sets))
        del sets
        perf["masked_attention"][name] = time_attention(
            dev, gen, b, s, h, heads, "uniform")
    say("2-encoder", e1_cases=ec.e1_cases, e1_max_abs_err=ec.e1_err,
        e1_atol=LN_ATOL, e2_cases=ec.e2_cases, e2_max_abs_err=ec.e2_err,
        e2_atol=ATTN_ATOL, e2_padding_invariant_rows=ec.invariant_rows,
        e2_scaled=ec.scaled, e2_scale=ENC_ATTN_SCALE,
        card=card, **{f"{k}_{shape}": v for k, t in perf.items()
                      for shape, v in t.items()})
    return perf


def time_attention(dev, gen, b, s, h, heads, kind):
    """E2's, its plain version's and SDPA's times at one shape, over
    `rotating` input sets, with a mask of attn_mask's `kind`; the bound
    in fp32 (check_encoder_kernels) and the route's 3xTF32 bound."""
    import torch
    import torch.nn.functional as F
    from cortex_tpu_torch.ops import encoder as enc
    t, dh = b * s, h // heads
    bias, kept = attn_mask(dev, gen, b, s, kind)
    m4 = bias[:, None, None, :]
    kept_keys = int(kept.sum())

    def attn_set():
        q, k, v = qkv_views(dev, gen, b, heads, s, dh)
        return q, k, v, q.contiguous(), k.contiguous(), v.contiguous()
    sets = rotating(attn_set, 4 * 6 * t * h)
    nbytes, flops = 4 * (4 * t * h + t), 4 * heads * dh * s * kept_keys
    ms = time_rotating(lambda q, k, v, *_: enc.masked_attention(
        q, k, v, bias), sets, 20)
    tc_bound = bound_ms(nbytes, 3 * flops, TF32_OPS_PER_S)
    out = timing(
        ms, time_rotating(lambda q, k, v, *_: enc.masked_attention_plain(
            q, k, v, bias), sets, 5),
        bound_ms(nbytes, flops, F32_OPS_PER_S),
        library_ms=time_rotating(
            lambda *a: F.scaled_dot_product_attention(
                *a[3:], attn_mask=m4), sets, 20),
        tc_bound_ms=tc_bound[0], tc_bound_by=tc_bound[1],
        share_of_tc_bound=tc_bound[0] / ms,
        shape=[b, heads, s, dh], kept_keys=kept_keys,
        walked_keys=walked_keys(kept), mask=kind, input_sets=len(sets))
    del sets
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ phase 9


@contextlib.contextmanager
def dedup_actions():
    """Record every dedup action (DedupScanner.execute_action) in the
    scope: (node_a, node_b, action, keep, retire)."""
    from cortex_tpu_torch.linker import dedup
    seen = []
    real = dedup.DedupScanner.execute_action

    def spy(self, pair):
        seen.append((pair.node_a, pair.node_b, pair.action, pair.keep,
                     pair.retire))
        return real(self, pair)

    dedup.DedupScanner.execute_action = spy
    try:
        yield seen
    finally:
        dedup.DedupScanner.execute_action = real


@contextlib.contextmanager
def plain_flat_kernels():
    """K1 and K2 replaced by their plain versions where the flat index
    calls them (ops.similarity's module globals, which
    cosine_topk_quant_exact reads)."""
    from cortex_tpu_torch.ops import similarity as sim
    real = sim.quant_candidates, sim.quant_rerank
    sim.quant_candidates = sim.quant_candidates_plain
    sim.quant_rerank = sim.quant_rerank_plain
    try:
        yield
    finally:
        sim.quant_candidates, sim.quant_rerank = real


def same_candidates(got, want, what):
    """Two candidate lists of one query: scores rank by rank within
    SCORE_ATOL, ids equal but where `want`'s scores tie to NEAR_TIE
    (at the last rank: where the two scores do)."""
    check(len(got) == len(want), f"{what}: {len(got)} != {len(want)} hits")
    ws = [v for _, v in want]
    np.testing.assert_allclose([v for _, v in got], ws, atol=SCORE_ATOL)
    for j, ((g, gv), (w, _)) in enumerate(zip(got, want)):
        if g != w:
            near = [abs(ws[j] - ws[t]) for t in (j - 1, j + 1)
                    if 0 <= t < len(ws)]
            if j == len(ws) - 1:
                near.append(abs(gv - ws[j]))
            check(min(near) <= NEAR_TIE,
                  f"{what}: rank {j} holds {g}, not {w}, beyond a near-tie")


def streamed_nodes(x_h, co, top, seed):
    """STREAM_NODES seeded nodes, each a noisy copy of a random live
    phase-3 row at cosine U(0.70, 0.99) to it, an hour apart (past the
    temporal rule's 30 minutes) after `top`, with agents from a pool of
    STREAM_AGENTS. Returns (nodes, unit rows [n, d] f32)."""
    from cortex_tpu_torch.types import Node, Source
    rng = np.random.default_rng(seed)
    live = np.array([f"r{i}" in co._row_of for i in range(len(x_h))])
    src = rng.choice(np.flatnonzero(live), STREAM_NODES)
    x = x_h[src]
    a = rng.uniform(0.70, 0.99, STREAM_NODES).astype(np.float32)[:, None]
    g = rng.standard_normal(x.shape).astype(np.float32)
    g -= (g * x).sum(1, keepdims=True) * x          # orthogonal to x
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    y = a * x + np.sqrt(1.0 - a * a) * g
    y = (y / np.linalg.norm(y, axis=1, keepdims=True)).astype(np.float32)
    kinds = ("fact", "event", "decision", "goal", "observation")
    agents = rng.integers(0, STREAM_AGENTS, STREAM_NODES)
    nodes = [Node(id=f"s{j:05d}", kind=kinds[j % 5],
                  title=f"streamed entry {j}", body="",
                  source=Source(agent=f"ag{agents[j]}"),
                  embedding=y[j].tolist(),
                  created_at=top + 3600.0 * (j + 1),
                  updated_at=top + 3600.0 * (j + 1))
             for j in range(STREAM_NODES)]
    return nodes, y


def check_similarity_weights(storage, vec_of, retired_to, threshold):
    """Every auto_similarity edge weighs the exact fp32 cosine of its
    endpoints' rows (to SCORE_ATOL) and at least the threshold; an edge
    that a dedup merge moved onto the kept node weighs the cosine of
    the retired one. Returns (edges checked, moved)."""
    edges = [e for e in storage.all_edges()
             if e.provenance.kind == "auto_similarity"]
    check(edges, "the linker made no similarity edge")
    a = np.stack([vec_of(e.from_id) for e in edges])
    b = np.stack([vec_of(e.to_id) for e in edges])
    cos = (a * b).sum(1, dtype=np.float32)
    w = np.array([e.weight for e in edges], np.float32)
    moved = 0
    for j in np.flatnonzero(np.abs(cos - w) > SCORE_ATOL).tolist():
        e = edges[j]
        alt = [float(vec_of(e.from_id) @ vec_of(r))
               for r in retired_to.get(e.to_id, ())] + \
              [float(vec_of(r) @ vec_of(e.to_id))
               for r in retired_to.get(e.from_id, ())]
        check(any(abs(c - w[j]) <= SCORE_ATOL for c in alt),
              f"edge {e.from_id} -> {e.to_id} weighs {w[j]}, its rows' "
              f"cosine is {cos[j]}")
        moved += 1
    check(bool((w >= threshold - SCORE_ATOL).all()),
          "a similarity edge weighs less than the rule's threshold")
    return len(edges), moved


def phase_linker(dev, index, storage, x_h, card):
    """Phase 9, the linker at the north star's scale: an AutoLinker built
    as Cortex builds it (the index, an embedder of the index's width,
    the default [auto_linker] config, the persist lock, the
    index-failure callback, the decay sweep on the card) over phase 5's
    flat index (1M x 768) and phase 7's MemoryStorage of 1M light nodes.
    The cursor is advanced past the 1M nodes, then STREAM_NODES new
    nodes arrive in batches of STREAM_BATCH through put_nodes_batch,
    with one run_cycle after each (config #5's ingest with a background
    scan). max_edges_per_cycle is raised to STREAM_EDGE_BUDGET: about
    half of the copies clear the 0.75 rule against the ~50 members of
    their cluster (mates sit at cosine ~0.89), ~25 edges a node, and the
    default 2,000 would stop each cycle after ~80 of its 500 nodes. The
    first cycle's candidate lists are held against K1's and K2's plain
    versions (uncounted) and against the exact oracle."""
    import threading
    import torch
    from cortex_tpu_torch.config import CortexConfig
    from cortex_tpu_torch.linker import AutoLinker
    from cortex_tpu_torch.utils import reset_stats, stats
    from cortex_tpu_torch.vector.embedding import HashingEmbedder
    co = index._corpus
    cfg = CortexConfig().auto_linker
    cfg.max_edges_per_cycle = STREAM_EDGE_BUDGET
    failed = []
    linker = AutoLinker(storage, index, HashingEmbedder(x_h.shape[1]), cfg,
                        persist_lock=threading.Lock(),
                        on_index_pair_failure=lambda: failed.append(1))
    linker.decay_engine.device = dev
    top = max((n.created_at, n.id) for n in storage._nodes.values())
    linker.advance_cursor(*top)
    nodes, y = streamed_nodes(x_h, co, top[0], seed=41)
    row_of_stream = {n.id: j for j, n in enumerate(nodes)}
    cap, planes = co._cap, [t.data_ptr() for t in (*co._dev, *co._dev_q)]

    first = {}
    real_stream = index.search_stream

    def spy(vectors, k, flt=None, batch=512, *, refine=True):
        got = real_stream(vectors, k, flt, batch, refine=refine)
        if not first:
            t0 = time.perf_counter()
            with uncounted(), plain_flat_kernels():
                first["plain"] = real_stream(vectors, k, flt, batch,
                                             refine=refine)
            co._search_path = "exact"
            first["exact"] = real_stream(vectors, k, flt, batch,
                                         refine=refine)
            co._search_path = "auto"
            first["got"], first["k"] = got, k
            first["check_s"] = time.perf_counter() - t0
        return got

    index.search_stream = spy
    before = launch_counts()
    # about half the streamed nodes make 30 or more candidate edges, and
    # the linker warns of "generic content" for each: keep stderr short
    quiet = logging.getLogger("cortex_tpu_torch.linker.auto_linker")
    level = quiet.level
    quiet.setLevel(logging.ERROR)
    walls, per_cycle = [], []
    reset_stats()
    try:
        with dedup_actions() as dedup:
            for b in range(0, STREAM_NODES, STREAM_BATCH):
                storage.put_nodes_batch(nodes[b:b + STREAM_BATCH])
                t0 = time.perf_counter()
                m = linker.run_cycle()
                walls.append(time.perf_counter() - t0)
                per_cycle.append(m.cycle_nodes_processed)
    finally:
        del index.search_stream
        quiet.setLevel(level)
    # the first cycle's comparisons ran inside its search span: not the
    # linker's time
    check("got" in first, "the first cycle did not search as a stream")
    walls[0] -= first["check_s"]
    spans = {k: {"count": v.count, "ms": v.total_s * 1e3}
             for k, v in stats().items() if k.startswith("linker.")}
    spans["linker.search"]["ms"] -= first["check_s"] * 1e3
    after = launch_counts()
    check(not failed, "an index insert failed after its storage write")
    m = linker.metrics
    last = nodes[-1]
    check((linker.cursor, linker.cursor_id) == (last.created_at, last.id),
          f"the cursor stopped at {linker.cursor_id}, not {last.id}")
    # the backlog gauge counts created_at >= the cursor, so a full page
    # leaves it 1 over (the cursor's own row, as the reference's
    # _backlog_after says); the backlog proper is what lies past the
    # cursor
    left = storage.list_nodes_since(linker.cursor, linker.cursor_id, 1)
    check(not left and m.backlog_size <= 1,
          f"backlog {m.backlog_size} ({len(left)} past the cursor) after "
          f"the stream")
    check(m.nodes_processed == STREAM_NODES,
          f"{m.nodes_processed} nodes processed of {STREAM_NODES}")
    retired = {r for _, _, act, _, r in dedup if act in ("merge",)}
    missing = [n.id for n in nodes
               if n.id not in index and n.id not in retired]
    check(not missing, f"{len(missing)} streamed nodes are not in the "
          f"index, e.g. {missing[:3]}")
    check(co._cap == cap and planes == [
        t.data_ptr() for t in (*co._dev, *co._dev_q)],
        "the streamed inserts regrew or re-uploaded the index")
    retired_to = {}
    for _, _, act, keep, gone in dedup:
        if act == "merge":
            retired_to.setdefault(keep, []).append(gone)

    def vec_of(nid):
        j = row_of_stream.get(nid)
        return y[j] if j is not None else x_h[int(nid[1:])]

    n_sim, moved = check_similarity_weights(
        storage, vec_of, retired_to, cfg.similarity.auto_link_threshold)
    got, plain, exact = first["got"], first["plain"], first["exact"]
    for j, (g, p) in enumerate(zip(got, plain)):
        same_candidates(g, p, f"cycle 0, query {j} against plain")
    k = first["k"]
    recall = float(np.mean([len({i for i, _ in g} & {i for i, _ in e}) / k
                            for g, e in zip(got, exact)]))
    check(recall >= 0.99, f"first cycle recall@{k} {recall} < 0.99")
    wall = float(sum(walls))
    search_s = spans["linker.search"]["ms"] / 1e3
    pairs = m.nodes_processed * cfg.candidate_k
    launched = {n: after[n] - before[n] for n in after}
    say("9-linker", old_nodes=len(storage._nodes) - STREAM_NODES,
        streamed=STREAM_NODES, batches=len(walls),
        nodes_per_cycle=per_cycle, cycle_wall_s_p50=statistics.median(walls),
        cycle_wall_s_max=max(walls), cycle_wall_s=walls, spans_ms=spans,
        auto_link_pairs_per_s=pairs / wall,
        auto_link_pairs_per_search_s=pairs / search_s,
        edges_created=m.edges_created,
        edges_created_per_s=m.edges_created / wall,
        similarity_edges=n_sim, moved_by_merge=moved,
        duplicates=len(dedup), first_cycle_recall_at_100=recall,
        first_cycle_queries=len(got), edge_budget=STREAM_EDGE_BUDGET,
        launches={n: launched[n] for n in ("quant_candidates",
                                           "quant_rerank", "decay_sweep")},
        index_rows=len(index), capacity=int(co._cap), card=card)
    del first, got, plain, exact
    torch.cuda.empty_cache()


# ----------------------------------------------------------- phase 10


def decay_by_chunks(fn, arrays):
    return [fn(*(a[s:s + DECAY_CHUNK] for a in arrays))
            for s in range(0, len(arrays[0]), DECAY_CHUNK)]


def compare_to_host(got, want, old_w):
    """D1 (through the engine) against decay_sweep_host on one chunk:
    new_w within HOST_ULPS, masks equal but on rows whose new_w lies
    within HOST_ULPS of a threshold (delete, prune) or of the old weight
    (changed). Returns (max ulps, rows whose masks differ)."""
    d = f32_ulps(got[0], want[0])
    check(int(d.max()) <= HOST_ULPS, f"D1 new_w {int(d.max())} ulps from "
          f"the host pass")
    near_thr = np.zeros(len(old_w), bool)
    for thr in (DECAY["delete_threshold"], DECAY["prune_threshold"]):
        near_thr |= f32_ulps(got[0], np.float32(thr)) <= HOST_ULPS
    near_old = f32_ulps(got[0], old_w) <= HOST_ULPS
    differ = 0
    for k, near in ((1, near_thr), (2, near_thr), (3, near_old)):
        diff = got[k] != want[k]
        check(not (diff & ~near).any(), "D1's masks differ from the host "
              "pass away from a threshold")
        differ += int(diff.sum())
    return int(d.max()), differ


def phase_decay_sweep(dev, card):
    """Phase 10 (a): DecayEngine._sweep_arrays from host numpy arrays at
    DECAY_EDGES (config #5's 10M) in the engine's DECAY_CHUNK chunks: the
    device election, H2D, D1 and D2H, against decay_sweep_host on the
    same arrays, twice each in turns (device, host, device, host)."""
    from cortex_tpu_torch.linker.config import DecayConfig
    from cortex_tpu_torch.linker.decay import DecayEngine
    from cortex_tpu_torch.ops import decay
    cfg = DecayConfig()
    rng = np.random.default_rng(43)
    n = DECAY_EDGES
    arrays = (rng.random(n, dtype=np.float32),
              (rng.random(n, dtype=np.float32) * 405.0 - 5.0
               ).astype(np.float32),
              rng.random(n, dtype=np.float32), rng.random(n) < 0.1)
    eng = DecayEngine(None, cfg, device=dev)
    check(decay.use_device_sweep(DECAY_CHUNK, dev),
          "the engine elects the host pass for a 1M chunk on this card")
    link = decay.device_transfer_bandwidth(dev)

    def host(*a):
        return decay.decay_sweep_host(
            *a, cfg.daily_decay_rate, cfg.importance_shield,
            cfg.delete_threshold, cfg.prune_threshold)

    t_dev, t_host = [], []
    launches = decay.decay_sweep.launches
    for _ in range(2):
        t0 = time.perf_counter()
        dev_out = decay_by_chunks(eng._sweep_arrays, arrays)
        t_dev.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        host_out = decay_by_chunks(host, arrays)
        t_host.append(time.perf_counter() - t0)
    check(decay.decay_sweep.launches - launches == 2 * n // DECAY_CHUNK,
          "the engine's sweep did not launch D1 once a chunk")
    worst, differ = 0, 0
    for j, (g, w) in enumerate(zip(dev_out, host_out)):
        u, dm = compare_to_host(g, w, arrays[0][j * DECAY_CHUNK:
                                                (j + 1) * DECAY_CHUNK])
        worst, differ = max(worst, u), differ + dm
    say("10-sweep", edges=n, chunk=DECAY_CHUNK, device_s=t_dev,
        host_s=t_host, device_edges_per_s=n / min(t_dev),
        host_edges_per_s=n / min(t_host), link_bytes_per_s=link,
        max_ulps_vs_host=worst, mask_rows_differing=differ, card=card)


def decay_store(path, now, seed):
    """A SQLite store of DECAY_STORE_NODES light nodes and
    DECAY_STORE_EDGES distinct edges (bulk_put_nodes / bulk_put_edges):
    seeded importance, weights U(0.02, 1), updated 0-400 days before
    `now` (a few just after it), 20 % manual."""
    from cortex_tpu_torch.storage import SqliteStorage
    from cortex_tpu_torch.types import Edge, EdgeProvenance, Node, Source
    rng = np.random.default_rng(seed)
    nn, ne = DECAY_STORE_NODES, DECAY_STORE_EDGES
    imp = rng.random(nn)
    src = Source(agent="seed")
    born = now - 500 * 86400.0
    s = SqliteStorage(path)
    s.bulk_put_nodes([Node(id=f"d{i}", kind="fact", title=f"d{i}", body="",
                           source=src, importance=float(imp[i]),
                           created_at=born, updated_at=born)
                      for i in range(nn)])
    j = np.arange(ne)
    frm, to = j % nn, (j % nn + 1 + j // nn) % nn
    w = rng.uniform(0.02, 1.0, ne).astype(np.float32)
    at = now - rng.uniform(-1.0, 400.0, ne) * 86400.0
    manual = rng.random(ne) < 0.2
    man, imp_p = EdgeProvenance.manual("seed"), EdgeProvenance.imported("x")
    s.bulk_put_edges([Edge(id=f"e{i}", from_id=f"d{frm[i]}",
                           to_id=f"d{to[i]}", relation="related_to",
                           weight=float(w[i]),
                           provenance=man if manual[i] else imp_p,
                           created_at=float(at[i]), updated_at=float(at[i]))
                      for i in range(ne)])
    s.close()


def decay_oracle(path, now, cfg):
    """decay_sweep_host on the store's own decay_scan, as the engine
    feeds it: {id: expected weight}, the deleted ids, the pruned count,
    the ids whose new_w lies within HOST_ULPS of the delete threshold,
    and the scan's and the host pass's seconds."""
    from cortex_tpu_torch.ops import decay
    from cortex_tpu_torch.storage import SqliteStorage
    s = SqliteStorage(path)
    t0 = time.perf_counter()
    chunks = list(s.decay_scan(chunk=DECAY_CHUNK))
    t_scan = time.perf_counter() - t0
    s.close()
    want, deleted, pruned, near, t_sweep = {}, set(), 0, set(), 0.0
    for ids, w, upd, imp, manual in chunks:
        days = ((now - upd) / 86400.0).astype(np.float32)
        t0 = time.perf_counter()
        nw, dl, pr, ch = decay.decay_sweep_host(
            w, days, imp, manual, cfg.daily_decay_rate,
            cfg.importance_shield, cfg.delete_threshold,
            cfg.prune_threshold)
        t_sweep += time.perf_counter() - t0
        um = ch & ~dl
        want.update(zip(ids, np.where(um, nw, w).tolist()))
        deleted.update(ids[i] for i in np.flatnonzero(dl))
        pruned += int(np.count_nonzero(pr & um))
        close = f32_ulps(nw, np.float32(cfg.delete_threshold)) <= HOST_ULPS
        near.update(ids[i] for i in np.flatnonzero(close))
    return want, deleted, pruned, near, t_scan, t_sweep


def check_decayed_store(path, oracle, got_counts, what):
    """The store after a sweep against the oracle: the same deletions
    (but for rows within HOST_ULPS of the delete threshold), weights
    within HOST_ULPS, one 'edge_deleted' audit row by 'decay' for each
    deletion, and the returned counts."""
    import sqlite3
    want, deleted, pruned, near, _, _ = oracle
    con = sqlite3.connect(path)
    try:
        stored = dict(con.execute("SELECT id, weight FROM edges"))
        audit = {r[0] for r in con.execute(
            "SELECT target_id FROM audit WHERE action = 'edge_deleted' "
            "AND actor = 'decay'")}
    finally:
        con.close()
    gone = want.keys() - stored.keys()
    check(not (gone ^ deleted) - near,
          f"{what}: deletions differ from the oracle away from the "
          f"threshold")
    check(audit == gone, f"{what}: audit rows do not match the deletions")
    ids = list(stored)
    d = f32_ulps(np.array([stored[i] for i in ids], np.float32),
                 np.array([want[i] for i in ids], np.float32))
    check(int(d.max()) <= HOST_ULPS, f"{what}: a weight is {int(d.max())} "
          f"ulps from the oracle")
    check(got_counts[1] == len(gone), f"{what}: deleted count")
    check(abs(got_counts[0] - pruned) <= len(near) and
          abs(got_counts[1] - len(deleted)) <= len(near),
          f"{what}: counts {got_counts} against the oracle's "
          f"({pruned}, {len(deleted)})")
    return int(d.max()), len(gone ^ deleted)


def phase_decay_store(dev, workdir, card):
    """Phase 10 (b): apply_decay end to end on a SQLite store of
    DECAY_STORE_EDGES edges (config #5's 10M cut to 1M for time), in
    process (D1 launched once: one 1M chunk) and through
    apply_decay_isolated (the worker process, on the card) on a byte
    copy made beforehand, each against the numpy oracle."""
    import shutil
    from cortex_tpu_torch.linker.config import DecayConfig
    from cortex_tpu_torch.linker.decay import DecayEngine
    from cortex_tpu_torch.ops import decay
    from cortex_tpu_torch.storage import SqliteStorage
    cfg = DecayConfig()
    now = time.time()
    inproc, worker = (os.path.join(workdir, f"decay_{w}.db")
                      for w in ("inproc", "worker"))
    t0 = time.perf_counter()
    decay_store(inproc, now, seed=47)
    t_load = time.perf_counter() - t0
    shutil.copyfile(inproc, worker)
    oracle = decay_oracle(inproc, now, cfg)
    s = SqliteStorage(inproc)
    launches = decay.decay_sweep.launches
    t0 = time.perf_counter()
    got_in = DecayEngine(s, cfg, device=dev).apply_decay(now)
    t_in = time.perf_counter() - t0
    s.close()
    check(decay.decay_sweep.launches - launches == 1,
          "apply_decay did not launch D1 for its 1M chunk")
    s = SqliteStorage(worker)
    t0 = time.perf_counter()
    got_w = DecayEngine(s, cfg, device=dev).apply_decay_isolated(worker, now)
    t_w = time.perf_counter() - t0
    s.close()
    ulps_in, edge_in = check_decayed_store(inproc, oracle, got_in,
                                           "in-process")
    ulps_w, edge_w = check_decayed_store(worker, oracle, got_w, "worker")
    say("10-apply-decay", edges=DECAY_STORE_EDGES, nodes=DECAY_STORE_NODES,
        load_s=t_load, oracle_scan_s=oracle[4], oracle_host_sweep_s=oracle[5],
        in_process_s=t_in, worker_s=t_w, pruned=got_in[0],
        deleted=got_in[1], worker_counts=list(got_w),
        max_ulps=[ulps_in, ulps_w], deletions_at_threshold=[edge_in, edge_w],
        card=card)


def phase_cortex_linker(dev, workdir, card):
    """Phase 10, then: Cortex.bulk_import and run_linker_cycle on phase
    8's SQLite store (CortexConfig(), 20,000 nodes, CX_EDGES edges):
    CX_IMPORT nodes through bulk_import(advance_linker_cursor=True),
    which the linker must not take up, then CX_STREAM through
    store_batch with cycles until the backlog is 0 (cycle 0 runs the
    decay sweep through the worker and dedup); the cursor persists
    across a close and reopen."""
    from cortex_tpu_torch import Cortex
    from cortex_tpu_torch.config import CortexConfig
    path = os.path.join(workdir, "cortex_flat.db")
    cx = Cortex.open(path, CortexConfig(), device=dev)
    check(cx.linker.cycle_count == 0, "the store's linker already ran")
    imported = seeded_nodes(CX_IMPORT, seed=5)
    t0 = time.perf_counter()
    got = cx.bulk_import(imported, advance_linker_cursor=True)
    t_import = time.perf_counter() - t0
    check(got == {"nodes": CX_IMPORT, "edges": 0}, f"bulk_import {got}")
    top = max((n.created_at, n.id) for n in imported)
    check((cx.linker.cursor, cx.linker.cursor_id) == top,
          "bulk_import did not advance the linker's cursor")
    streamed = seeded_nodes(CX_STREAM, seed=6)
    cx.store_batch(streamed)
    walls, processed = [], 0
    with dedup_actions() as dedup:
        while True:
            t0 = time.perf_counter()
            m = cx.run_linker_cycle()
            walls.append(time.perf_counter() - t0)
            processed += m.cycle_nodes_processed
            if m.backlog_size == 0:
                break
            check(len(walls) < 200, "the backlog does not drain")
    check(processed == CX_STREAM, f"{processed} nodes linked, not "
          f"{CX_STREAM}: the imported ones must be skipped")
    in_dedup = {x for p in dedup for x in p[:2]}
    linked = [n.id for n in imported if cx.storage.edges_from(n.id)
              and n.id not in in_dedup]
    check(not linked, f"{len(linked)} imported nodes were linked")
    state = (cx.linker.cursor, cx.linker.cursor_id, cx.linker.cycle_count)
    edges = cx.storage.stats().edge_count
    cx.close()
    cx = Cortex.open(path, CortexConfig(), device=dev)
    check((cx.linker.cursor, cx.linker.cursor_id,
           cx.linker.cycle_count) == state,
          "the linker's cursor did not persist across the reopen")
    idle = cx.run_linker_cycle()
    check(idle.cycle_nodes_processed == 0, "a reopened linker re-linked")
    cx.close()
    say("10-cortex-linker", imported=CX_IMPORT, import_s=t_import,
        streamed=CX_STREAM, cycles=len(walls),
        cycle_wall_s_p50=statistics.median(walls), cycle_wall_s=walls,
        edges=edges, duplicates=len(dedup), cursor_persisted=True,
        card=card)


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


# ------------------------------------------------------------ phase 11


def encoder_words(seed):
    """ENC_WORDS distinct made-up words of 2-3 syllables of a seeded
    70-syllable alphabet, and the syllables."""
    rng = np.random.default_rng(seed)
    syllables = [c + v for c in "bdfgklmnprstvz" for v in "aeiou"]
    words = set()
    while len(words) < ENC_WORDS:
        words.add("".join(rng.choice(syllables, rng.integers(2, 4))))
    return sorted(words), syllables


def encoder_vocab(words, syllables, size):
    """A WordPiece vocabulary of `size` entries (BGE-small's 30,522):
    special tokens, the node text's fixed words and punctuation, the
    words, ## pieces (every syllable and a few suffixes) and unused
    filler."""
    head = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", ":", ",", ".",
            "tags", *ENC_KINDS]
    pieces = [f"##{s}" for s in syllables] + ["##s", "##ed", "##ing",
                                              "##er", "##ly"]
    vocab = head + words + pieces
    vocab += [f"[unused{i}]" for i in range(size - len(vocab))]
    check(len(vocab) == len(set(vocab)) == size,
          "the encoder vocabulary is not 30,522 distinct entries")
    return vocab


def encoder_nodes(n, seed, words):
    """Seeded nodes whose texts cluster by topic (each takes most of its
    words from one of ENC_TOPICS 40-word groups, the rest from anywhere):
    titles of 4 words, bodies of U(15, 80) words (25-100 tokens), and of
    U(470, 520) words for ENC_LONG of them (truncated at 512 tokens), so
    that nearly every chunk of a bulk import pads to 512. Every 9th body
    word takes a suffix that WordPiece splits off."""
    from cortex_tpu_torch.types import Node, Source
    rng = np.random.default_rng(seed)
    words = np.array(words)
    suffixes = np.array(["s", "ed", "ing", "er", "ly"])
    out = []
    for i in range(n):
        topic = int(rng.integers(0, ENC_TOPICS)) * 40
        nb = int(rng.integers(470, 521) if rng.random() < ENC_LONG
                 else rng.integers(15, 81))
        own = words[topic + rng.integers(0, 40, nb + 4)]
        other = rng.random(nb + 4) < 0.2
        own[other] = rng.choice(words, int(other.sum()))
        body = own[4:].astype(object)
        body[::9] = body[::9] + rng.choice(suffixes, len(body[::9]))
        out.append(Node.new(ENC_KINDS[i % len(ENC_KINDS)],
                            " ".join(own[:4]), " ".join(body),
                            Source(agent=f"agent{i % 7}"),
                            float(rng.uniform(0.2, 0.9))))
    return out


def check_encoder_forward(emb, params, cfg, wp, texts):
    """The card's forward against the port's CPU forward (the plain
    versions of E1 and E2) on ENC_SAMPLE texts, short ones in one batch
    and two near 512 tokens in another; then texts embedded alone against
    the same texts inside a batch of mixed lengths (padded to 512). Each
    to ENC_ATOL and cosine >= ENC_COS."""
    from cortex_tpu_torch.models.encoder import BertEncoder, bert_encode
    cpu = BertEncoder.from_params(params, cfg, device="cpu")
    short = [t for t in texts if len(t.split()) < 120][:ENC_SAMPLE - 2]
    long = [t for t in texts if len(t.split()) > 460][:2]
    worst = {"max_abs_err": 0.0, "min_cos": 1.0}

    def hold(got, want, what):
        err = float(np.abs(got - want).max())
        cos = float(np.min(np.sum(got * want, axis=1)))
        check(err <= ENC_ATOL and cos >= ENC_COS,
              f"{what}: max abs {err}, min cosine {cos}")
        worst["max_abs_err"] = max(worst["max_abs_err"], err)
        worst["min_cos"] = min(worst["min_cos"], cos)

    for group in (short, long):
        if not group:
            continue
        ids, mask = wp.encode_batch(group, max_length=cfg.max_position)
        hold(bert_encode(emb.model, ids, mask), bert_encode(cpu, ids, mask),
             "the card's forward against the CPU's")
    mixed = short[:6] + long[:1]
    batch = emb.embed_batch(mixed)
    hold(np.stack([emb.embed(t) for t in mixed]), batch,
         "texts alone against them in a mixed batch")
    return {"sample": len(short) + len(long), "seq": [
        int(wp.encode_batch(g, max_length=cfg.max_position)[0].shape[1])
        for g in (short, long) if g], **worst}


def encoder_oracle(cx, queries, dev):
    """The exact top-(K + 1) of each query text over every stored
    embedding: the queries embedded by the Cortex's embedder (one batch),
    fp32 products on the card (TF32 off), as [(score, node)] lists; and
    the spread of the stored embeddings' pairwise cosines."""
    import torch
    from types import SimpleNamespace
    from cortex_tpu_torch.storage import NodeFilter
    stored = [n for n in cx.storage.list_nodes(NodeFilter())]
    x = torch.from_numpy(np.asarray([n.embedding for n in stored],
                                    np.float32)).to(dev)
    q = torch.from_numpy(cx.embedder.embed_batch(queries)).to(dev)
    scores, rows = torch.topk(q @ x.T, K + 1, dim=1)
    ids = [SimpleNamespace(id=n.id) for n in stored]
    out = [[(float(s), ids[r]) for s, r in zip(sc, rw)]
           for sc, rw in zip(scores.cpu().tolist(), rows.cpu().tolist())]
    sample = x[torch.randperm(len(stored), device=dev)[:2000]]
    cos = (sample @ sample.T)[~torch.eye(len(sample), dtype=torch.bool,
                                         device=dev)]
    spread = {f"p{p}": float(torch.quantile(cos, p / 100))
              for p in (1, 50, 99)}
    spread.update(min=float(cos.min()), max=float(cos.max()))
    return out, spread


def rejected(want, got):
    """Whether same_hits refuses `got` against `want`."""
    try:
        same_hits(want, got)
    except AssertionError:
        return True
    return False


def oracle_margins(hits, oracle):
    """How far the searches' check can tell hits apart. Each oracle list
    holds K + 1 hits. Returns the searches whose ids (in order) differ
    from the oracle's top K, the median gap between the oracle's rank 1
    and rank K and between its ranks K and K + 1, and how many searches
    same_hits rejects when handed the oracle's list with its rank 1
    missed (ranks 2 to K + 1) or its rank K missed (rank K + 1 in its
    place), as a candidate scan that lost a true hit would return. The
    first control must be rejected in every search: otherwise the
    scores lie too close for the check to see a lost hit."""
    top = [o[:K] for o in oracle]
    missed_top = sum(rejected(t, o[1:]) for t, o in zip(top, oracle))
    missed_last = sum(rejected(t, o[:K - 1] + o[K:])
                      for t, o in zip(top, oracle))
    check(missed_top == len(oracle),
          f"same_hits passed {len(oracle) - missed_top} searches whose "
          f"rank 1 was missed")
    return {"ids_differ": sum([n.id for _, n in g] != [n.id for _, n in t]
                              for g, t in zip(hits, top)),
            "gap_rank1_rankK_p50": float(np.median(
                [o[0][0] - o[K - 1][0] for o in oracle])),
            "gap_rankK_rankK1_p50": float(np.median(
                [o[K - 1][0] - o[K][0] for o in oracle])),
            "missed_rank1_rejected": missed_top,
            "missed_rankK_rejected": missed_last}


def encoder_queries(nodes, words, n, seed):
    """n query texts: a node's title, its title and 10 body words, or 6
    words of one topic (thirds of each)."""
    rng = np.random.default_rng(seed)
    out = []
    for j in range(n):
        node = nodes[int(rng.integers(0, len(nodes)))]
        if j % 3 == 0:
            out.append(node.title)
        elif j % 3 == 1:
            out.append(f"{node.title} {' '.join(node.body.split()[:10])}")
        else:
            topic = int(rng.integers(0, ENC_TOPICS)) * 40
            out.append(" ".join(words[topic + i]
                                for i in rng.integers(0, 40, 6)))
    return out


def encoder_cortex(dev, workdir, npz, words, index):
    """Cortex with `[embedding] model = "flax:<npz>"` on SQLite, on the
    flat index (the default: K1 + K2 at this size) or the IVF index (every
    list probed, so exact): bulk_import ENC_NODES, store ENC_STORES one by
    one, then ENC_SEARCHES text searches (decay off, so the hits are the
    index's fp32 scores) held to the exact oracle (same_hits), with the
    margins that show the check can fail (oracle_margins)."""
    import torch
    from cortex_tpu_torch import Cortex
    from cortex_tpu_torch.config import CortexConfig
    from cortex_tpu_torch.vector.embedding import TorchEncoderEmbedder
    cfg = CortexConfig()
    cfg.embedding.model = f"flax:{npz}"
    cfg.embedding.dimension = 384
    if index == "ivf":
        cfg.embedding.index = "ivf"
        cfg.embedding.ivf_graph_degree = 0
        cfg.embedding.ivf_nprobe = 1 << 20
    cx = Cortex.open(os.path.join(workdir, f"encoder_{index}.db"), cfg,
                     device=dev)
    check(isinstance(cx.embedder, TorchEncoderEmbedder)
          and cx.embedder.model.device.type == "cuda"
          and cx.embedder.model_name == f"flax:{npz}",
          f"the {index} Cortex does not serve the encoder on the card")
    nodes = encoder_nodes(ENC_NODES + ENC_STORES, ENC_SEED, words)
    t0 = time.monotonic()
    got = cx.bulk_import(nodes[:ENC_NODES])
    t_bulk = time.monotonic() - t0
    check(got["nodes"] == ENC_NODES, f"bulk_import stored {got}")
    store_ms = []
    for node in nodes[ENC_NODES:]:
        t0 = time.monotonic()
        cx.store(node)
        store_ms.append((time.monotonic() - t0) * 1e3)
    info = cx.index.index_info()
    check(len(cx.index) == ENC_NODES + ENC_STORES, "the index lost nodes")
    if index == "flat":
        check(info["resolved_path"] == "quant",
              f"the flat Cortex serves through {info}")
    queries = encoder_queries(nodes, words, ENC_SEARCHES, ENC_SEED + 1)
    search_ms, hits = [], []
    for text in queries:
        t0 = time.monotonic()
        hits.append(cx.search(text, K, decay=False, record_access=False))
        search_ms.append((time.monotonic() - t0) * 1e3)
    with uncounted():
        want, spread = encoder_oracle(cx, queries, dev)
    for w, g in zip(want, hits):
        same_hits(w[:K], g)
    margins = oracle_margins(hits, want)
    cx.close()
    torch.cuda.empty_cache()
    return {"bulk_import_s": t_bulk,
            "bulk_texts_per_s": ENC_NODES / t_bulk,
            "store_ms_p50": float(np.percentile(store_ms, 50)),
            "store_ms_p99": float(np.percentile(store_ms, 99)),
            "search_ms_p50": float(np.percentile(search_ms, 50)),
            "search_ms_p99": float(np.percentile(search_ms, 99)),
            "searches_equal_to_oracle": len(queries),
            "resolved_path": info.get("resolved_path", info["kind"]),
            "pooling": cx.embedder.model.cfg.pooling,
            "pairwise_cos": spread, "oracle_margins": margins}


def encoder_speed(emb, cfg, dev):
    """ms a batch and texts/s of the embedder's forward (embed_tokens:
    embed_batch's chunks of chunk_rows(512) rows, H2D of the ids and D2H
    of the embeddings; tokenizing apart) at ENC_SPEED, on seeded ids with
    every position kept; and
    the forward's fp32 FLOP/s (the products' 24 h^2 and attention's
    4 S h a token and layer) against the card's 67 TFLOP/s."""
    import torch
    gen = np.random.default_rng(12)
    out = {}
    for s in ENC_SPEED_SEQS:
        for b in ENC_SPEED_BATCHES:
            ids = gen.integers(1000, cfg.vocab_size, (b, s)).astype(np.int32)
            mask = np.ones((b, s), np.int32)
            reps = 1 if b * s >= 500_000 else 5
            # one run of the large ones (0.1-3 s), beside which a first
            # call's set-up is small
            if reps > 1:
                emb.embed_tokens(ids, mask)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                emb.embed_tokens(ids, mask)
            ms = (time.perf_counter() - t0) * 1e3 / reps
            flops = b * s * cfg.layers * (24 * cfg.hidden ** 2
                                          + 4 * s * cfg.hidden)
            out[f"b{b}_s{s}"] = {
                "ms": ms, "texts_per_s": b / ms * 1e3,
                "tflops": flops / ms / 1e9,
                "share_of_fp32_peak": flops / ms * 1e3 / F32_OPS_PER_S}
    return out


def encoder_profile(emb, cfg):
    """One traced forward at B = 64, S = 128, one at the embedder's
    S = 512 chunk with every key kept and one at that chunk with phase
    11's lengths (attn_mask's "mix"): device ms by kernel, and the shares
    of the products (cuBLAS gemm kernels), E1, E2, GELU and the rest of
    the device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out = {}
    rows = emb.chunk_rows(512)
    gen = torch.Generator()
    gen.manual_seed(ENC_SEED)
    for b, s, mix in ((64, 128, False), (rows, 512, False),
                      (rows, 512, True)):
        ids = np.random.default_rng(s).integers(
            1000, cfg.vocab_size, (b, s)).astype(np.int32)
        mask = np.ones((b, s), np.int32)
        if mix:
            mask = attn_mask("cpu", gen, b, s, "mix")[1].numpy().astype(
                np.int32)
        emb.embed_tokens(ids, mask)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            emb.embed_tokens(ids, mask)
            torch.cuda.synchronize()
        dev_ms = {e.key: e.self_device_time_total / 1e3
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA}
        total = sum(dev_ms.values())
        check(total > 0, "the profiler saw no device time")
        parts = {"gemm": ("gemm",), "e1": ("add_ln_",),
                 "e2": ("masked_attention_tc_kernel",), "gelu": ("gelu",)}
        share = {p: sum(v for k, v in dev_ms.items()
                        if any(m in k.lower() for m in marks)) / total
                 for p, marks in parts.items()}
        share["other"] = 1 - sum(share.values())
        out[f"b{b}_s{s}" + ("_mix" if mix else "")] = {
            "device_ms": total, "share": share, "kernels": len(dev_ms),
            "kept_tokens": int(mask.sum())}
    return out


def phase_encoder(dev, workdir, card):
    """Phase 11: the text encoder at the full BGE-small-en-v1.5 width
    (vocab 30,522, hidden 384, 12 layers of 12 heads, intermediate 1,536,
    512 positions, CLS pooling) with seeded random weights written by the
    port's own init_params + save_npz with a made-up vocabulary; the
    card's forward held to the CPU's; Cortex on the flat index (CLS) and
    the IVF index (the same weights, mean pooling); then the forward's
    speed and a trace."""
    from cortex_tpu_torch.models.encoder import (BertEncoderConfig,
                                                 init_params,
                                                 load_npz_tokenizer,
                                                 save_npz)
    from cortex_tpu_torch.vector.embedding import (TorchEncoderEmbedder,
                                                   embedding_input)
    t_phase = time.monotonic()
    words, syllables = encoder_words(ENC_SEED)
    cfg = BertEncoderConfig()
    vocab = encoder_vocab(words, syllables, cfg.vocab_size)
    params = init_params(cfg, seed=ENC_SEED)
    npz = os.path.join(workdir, "bge_small_random.npz")
    save_npz(npz, params, cfg, vocab=vocab)
    wp = load_npz_tokenizer(npz)
    texts = [embedding_input(n) for n in encoder_nodes(2000, ENC_SEED,
                                                       words)]
    t0 = time.perf_counter()
    ids, mask = wp.encode_batch(texts, max_length=cfg.max_position)
    tok_s = time.perf_counter() - t0
    tokens = int(mask.sum())
    check(ids.shape[1] == cfg.max_position
          and 20 <= np.median(mask.sum(1)) <= 100,
          f"the length mix is off: S {ids.shape[1]}, median "
          f"{np.median(mask.sum(1))} tokens")
    emb = TorchEncoderEmbedder(npz, device=dev)
    with uncounted():
        forward = check_encoder_forward(emb, params, cfg, wp, texts)
    # the IVF leg's model pools by the masked mean (the reference's other
    # pooling), whose random-weight embeddings lie further apart
    npz_mean = os.path.join(workdir, "bge_small_random_mean.npz")
    save_npz(npz_mean, params, replace(cfg, pooling="mean"), vocab=vocab)
    out = {index: encoder_cortex(dev, workdir, path, words, index)
           for index, path in (("flat", npz), ("ivf", npz_mean))}
    with uncounted():
        speed = encoder_speed(emb, cfg, dev)
        trace = encoder_profile(emb, cfg)
    say("11-encoder", config={k: getattr(cfg, k) for k in (
        "vocab_size", "hidden", "layers", "heads", "intermediate",
        "max_position", "pooling")}, nodes=ENC_NODES, stores=ENC_STORES,
        searches=ENC_SEARCHES, long_share=ENC_LONG,
        tokenizer_tokens_per_s=tokens / tok_s,
        median_tokens=float(np.median(mask.sum(1))), forward=forward,
        chunk_rows_s512=emb.chunk_rows(512), speed=speed, trace=trace,
        phase_s=time.monotonic() - t_phase, card=card, **out)


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
    dc = DecayCheck()
    perf = {"decay_sweep": check_decay(dc, dev, gen, card)}
    ec = EncoderKernelCheck()
    perf.update(check_encoder_kernels(ec, dev, gen, card))
    perf.update(check_graph_big(gc, dev, gen, card))
    torch.cuda.empty_cache()
    index, q_np, q_lat, ivf_perf, rows = phase_index(dev, N_BIG, D_BIG,
                                                     gen, kc)
    perf["probed_scores"] = ivf_perf

    # five main paths, each read just after it: IVF (3-4), flat (5-6),
    # graph (7-8), linker (9-10) and encoder (11); 9 runs between 7 and 6
    # because it needs phase 5's index and phase 7's storage
    flat, graph = ("quant_candidates", "quant_rerank"), (
        "frontier_bfs", "frontier_bfs_compact", "bfs_relax")
    linker = ("quant_candidates", "quant_rerank", "decay_sweep")
    encoder = ("add_layer_norm", "masked_attention", "quant_candidates",
               "quant_rerank", "probed_scores")
    launches = {"ivf": {}, "flat": {}, "graph": {}, "linker": {},
                "encoder": {}}

    def take(path, names):
        counts = launch_counts()
        for n in names:
            launches[path][n] = launches[path].get(n, 0) + counts[n]

    reset_launches()                          # the IVF main path
    phase_search(index, q_np, q_lat, gen, dev, card)
    del index
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as workdir:
        phase_cortex(dev, workdir)
    take("ivf", ["probed_scores"])

    index, flat_perf = phase_flat_build(dev, rows, fc)
    perf.update(flat_perf)
    x_h = rows[0]
    rows = (None, *rows[1:3], None, rows[4])   # phase 7: ids, kinds, member
    reset_launches()                          # the flat main path
    phase_flat_search(index, q_np, q_lat, gen, dev, card)
    take("flat", flat)
    reset_launches(flat + graph)              # the graph main path
    storage = phase_hybrid(dev, index, rows, gc, card)
    take("graph", flat + graph)
    reset_launches(linker)                    # the linker main path
    phase_linker(dev, index, storage, x_h, card)
    take("linker", linker)
    del index, rows, storage, x_h
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as workdir:
        reset_launches(flat)
        phase_cortex_flat(dev, workdir)
        take("flat", flat)
        reset_launches(flat + graph)
        phase_cortex_graph(dev, workdir, gc, card)
        take("graph", flat + graph)
        reset_launches(linker)
        phase_decay_sweep(dev, card)
        phase_decay_store(dev, workdir, card)
        phase_cortex_linker(dev, workdir, card)
        take("linker", linker)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as workdir:
        reset_launches(encoder)
        phase_encoder(dev, workdir, card)
        take("encoder", encoder)
    for path, counts in launches.items():
        for name, n in counts.items():
            check(n > 0, f"the {path} main path never launched {name}")

    errs = {"probed_scores": kc.max_abs_err, "quant_candidates": fc.k1_err,
            "quant_rerank": fc.k2_err, "decay_sweep": dc.max_abs_err,
            "add_layer_norm": ec.e1_err, "masked_attention": ec.e2_err,
            **gc.max_abs_err}
    main_shapes = {"probed_scores": (f"b{BATCH}", "b1"),
                   "quant_candidates": (f"b{BATCH}_cand{FLAT_CANDS[0]}",
                                        f"b1_cand{FLAT_CANDS[0]}"),
                   "quant_rerank": (f"b{BATCH}", "b1"),
                   "frontier_bfs": ("a1_h3", None),
                   "frontier_bfs_compact": ("a1_h3", None),
                   "bfs_relax": ("a1_r3", None),
                   "decay_sweep": ("e10M", None),
                   "add_layer_norm": ("b64_s128", "b1_s32"),
                   "masked_attention": ("b64_s128", "b1_s32")}
    say("2-bounds", card=card, **{
        name: {shape: {k: t[k] for k in (
            "ms", "bound_ms", "bound_by", "share_of_bound", "tc_bound_ms",
            "share_of_tc_bound") if k in t}
               for shape, t in perf[name].items()}
        for name in KERNELS})
    check_no_reference_import()
    kernels = []
    for name, (src, repl) in KERNELS.items():
        head, second = main_shapes[name]
        t = perf[name][head]
        by_path = {p: c[name] for p, c in launches.items() if name in c}
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": errs[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t.get("library_ms"), "shape": head}
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
