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
     1M x 768 planes, K1 beside torch._int_mm's product alone. The decay sweep (D1) at 1, 31 and 65,537 edges and
     at 10,000,000 (config #5's scale, made on the card; days <= 0,
     exempt rows, importance * shield = 1, rows exactly on each
     threshold): new_w and its masks bit-equal to the plain version;
     its and the plain version's times at 10M and at the engine's 1M
     chunk beside the bound in bytes (20 B an edge). The text encoder's
     residual + LayerNorm (E1) at h 36, 384 and 768 (also at T on both
     sides of its launch shape's switches, 2 and 4 x the SM count), its
     embedding form at the same widths, S 1, 31, 128 and 512, int32 and
     int64 ids with ids 0, V - 1 and past both ends, and positions past
     P (held within LN_ATOL of its plain version), both also at each
     ENC_TIMED shape (up to the S 512 chunk's 99,840 rows), each case
     with the launch form the kernel took there (every form must be
     reached, each held within LN_ATOL), and its masked
     attention (E2) at (B 5, H 3, dh 32), BGE-small's (H 12, dh 32) and
     dh 64, each at S 1, 31, 128 and 512 and at E2's tile edges (S 63,
     64, 65, 127, 129) with padded rows, at the mask patterns of
     kept_patterns (kept keys ending on and one past a tile edge, masked
     keys in front and in the middle, a wholly masked tile between two
     kept ones, only the last key kept) and at dh 64, S 512, B * H 3,072
     (E1 also with an [S, h] residual): within LN_ATOL and
     ATTN_ATOL of the plain versions, and E2's kept rows bit-equal after
     new values at every masked key; E2 with |q| and |k| 10x larger,
     where the plain fp32 version is itself further than ATTN_ATOL from
     the float64 answer: no further from it than the plain version plus
     ATTN_ATOL. Then the times of each, its plain version and one
     PyTorch call computing the same function (F.layer_norm on the
     pre-summed input, scaled_dot_product_attention with the mask bias;
     for the embedding form none, so the three launches it replaces:
     F.embedding, the [S, h] position + type add and E1)
     at ENC_TIMED (E2 also at ENC_MIX: the S 512 chunk with phase 11's
     lengths and with every key kept)
     over input sets that together exceed the L2 four times (so read
     from HBM), beside the bound (E1: bytes; the embedding form: bytes
     of the ids, the distinct rows they gather, the position rows, the
     type row, g, b and y; E2: bytes or fp32 FLOPs of
     the kept keys, the larger, and beside it the bound of its route:
     3 TF32 products per fp32 product at 495 TFLOP/s), and the host
     microseconds of one E1 and one embedding-form call at B 1 / S 32
     (10,000 calls on a layer's tensors). The kNN-graph
     block kernel (N1) against its plain version, list for list: small
     and odd (L 37, d 100, a list with 3 live slots, r 1, 12 and 36),
     phase 4's 384-d layout (144 lists of 192 slots, r 32), the 10M
     auto layout's lists (4 of 4,096 x 768, r 32) and lists past the
     first design's shared-memory limit (2 of 8,192 x 768, r 32), the
     last two timed beside their bounds; at phase 3's
     1M layout, on its first 64 lists at r 32 and r = L - 1, with their
     and the plain version's times beside the bound (operations: the
     L (L - 1) / 2 distinct dots of a list's symmetric self-product,
     L (L - 1) d int8 operations, at 1,979 TOP/s; bytes: the lists' rows
     and planes read once, the lists written once), and torch._int_mm
     over one list's
     block times C ("product only"); K1 at the nprobe tuner's shape (256
     queries, cand 32, over the tuner's chunk of the flattened layout,
     dead slots biased to NEG_INF), checked and timed as above.
     Retention eligibility (R1) at 1, 31 and 65,537 nodes and at
     10,000,000 (the reference's decay_scale_bench scale, made on the
     card; rows exactly on the TTL, grace and score boundaries), with
     the parameters broadcast and one a node: the mask bit-equal to the
     plain version; its and the plain version's times at 10M and 1M
     beside the bound in bytes (14 B a node, 31 with per-node
     parameters);
  3. the IVF index at 1,000,000 x 768 (seeded clustered unit rows), with
     the kNN graph at the default degree 32, built on its background
     thread (the build's wall split into device work, the merge on the
     device and the table's fetch, and N1's launches): at nprobe = nlist
     the top-10 of 64
     queries equals the exact fp32 oracle (near-ties of 1e-6 may swap);
     at the default nprobe the recall@10, batch-64 throughput (median of
     5 runs of 30 batches) and batch-1 latency (p50 and p99 over 1,000
     queries), refined; recall@10 at nprobe 128, 16, 4 and 1 with refine
     on and off (refined never below unrefined), for these queries and
     for 64 hard ones (corpus rows plus 1.0 x noise), and the speeds
     unrefined;
     then 1,000 inserts and 100 removes through the incremental update;
     then a second index over the same rows with ivf_target_recall 0.95,
     whose build (sync) runs the nprobe tuner: its pick, curve,
     delivered recall and candidate boost read from index_info(), the
     build's wall, its graph swapped in, and recall@10 at its pick for
     phase 3's queries against the exact oracle;
  4. the Cortex slice: Cortex.open on SQLite with index = "ivf" (every
     list probed, no graph), store_batch 20,000 seeded nodes, store /
     delete_node, searches with decay and record_access, a kind filter
     and > 64 exclusions; the same searches at the default nprobe
     against the exact results; close, reopen (rebuild from storage:
     snapshot_boot = false, as in phase 6),
     the same results; then CortexConfig() with only index = "ivf" (the
     reference's IVF defaults: graph degree 32, auto nprobe), and the
     same with ivf_target_recall = 0.95, in memory over 20,000 nodes:
     every hit scores its exact cosine, every oracle top-10 row that a
     probed list holds is returned, each sampled node's own text returns
     it first unless no probed list holds it;
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
     of 250,000 edges (config #5's 10M cut for time), in process and through
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
     torch.profiler trace of a forward at B 1, S 32, at B 64, S 128, at
     the S 512 chunk with every key kept and at the S 512 chunk with
     phase 11's lengths: its kernel launches (one embedding form and 2
     E1 a layer), device ms and the shares of the products, E1, the
     embedding form, E2 and GELU in it, beside its host ms untraced;
 12. the host services, in three parts. After phase 4, on its Cortex at
     the IVF defaults: SVC_GATE_IVF gated stores (half re-submit a
     stored node's text under a new id, planted duplicates; a sixth are
     same-kind near copies by another agent; a twelfth fail substance
     or specificity; the rest are fresh), each decision (check and
     existing node) equal to WriteGate.check_all over the exact top 5 of
     the rows the query's probed lists hold (near-ties within 1e-5 of a
     threshold, or of each other past it, counted), every planted
     duplicate rejected as a conflict unless no probed list holds its
     original. After phase 10, on phase 8's store with a [retention]
     section: SVC_AGENTS agents' briefing world and SVC_RET_NODES aged
     nodes (ages 0-200 days, edges into a tenth) and backdated
     tombstones; closed, byte-copied with its index snapshot, reopened
     from it on the card and on the
     CPU (device "cpu"): briefing_full and both renderings for every
     agent, equal but for the clock and hybrid-score ties, the cache and
     its invalidation; run_retention on both, equal swept and purged
     ids, no swept node in the index or a search; R1 over the same
     nodes, a launch per sweep pass and one with per-node parameters,
     equal to the engine's decisions but within RET_BAND_S of a
     boundary (counted); queries and stats equal to the CPU's; reindex
     with the same hits before and after and the old index released;
     prompts created, versioned, selected and rolled back. After phase
     11, on its flat Cortex (BGE-small width): SVC_UNGATED ungated and
     SVC_GATE_FLAT gated stores, held to an exact fp32 numpy top 5 over
     the stored embeddings, every planted duplicate rejected; the store
     times of both.
 13. index snapshots and the serving surfaces, in three parts. Right
     after phase 3's searches, on its 1M x 768 IVF index (graph built):
     snapshot_state + write_snapshot timed, the file's bytes, load into a
     fresh TorchIvfIndex plus its first search timed (the lists packed
     from the file's clustering: no k-means, no tuning pass, no N1
     launch; SNAP_MUTATED rows mutated between the base and a delta
     link, and the boot loads base + link as Cortex does), the same
     centroids, at least SNAP_HOME_SHARE of the unmutated rows in their
     saved home list, the same graph by ids, the same ids, kinds and
     agents, rows within SNAP_ROW_ATOL, and the top-10 of phase 3's
     queries equal to the in-memory index's (NEAR_TIE) at the default
     nprobe and at nprobe = nlist. The same
     round trip on phase 5's flat index after phase 9 (equal on the auto
     path and on the exact product). After phase 12's flat gate, the
     composed server (Server(config, device="cuda"): HTTP + SSE, gRPC,
     the background loops) on phase 11's encoder store, copied with its
     snapshot to <data_dir>/cortex.db: a boot from the snapshot with
     warmup, SERVE_REQUESTS gated POST /nodes and GET /search (p50,
     p99), SERVE_CONCURRENT concurrent clients through the search
     batcher (q/s), briefing, /stats and /metrics, gRPC create and
     search, MCP store and search, the served hits equal to the
     in-process search; `python -m cortex_tpu_torch --config ... serve`
     in a process of its own, from the snapshot (its close appends a
     delta link), a search and a write, SIGTERM, exit 0; a boot with
     snapshot_boot = false (a rebuild);
     a boot from the snapshot again with every acknowledged write found
     by GET /nodes/:id and by a search, its first search cold (warmup
     off; the kernel library is loaded in this process already) beside
     the first boot's warm one. Without a serving package
     (SERVE_MODULES) the phase names it and drives what runs without it.

 14. the mesh (parallel/), on virtual meshes of the one card
     (MESH_LAYOUTS: 4 shards of cuda:0, and 2 replica groups of 2
     shards), in three parts. Right after phase 3's build, on its rows:
     a ShardedIvfIndex on each mesh (the rows cloned from phase 3's
     index, its clustering as boot hints, so the same lists; packed,
     placed list by list and the kNN graph built anew with N1), at
     nprobe = nlist the top-10 of phase 3's queries equal to phase 3's
     index's at batch 64 and batch 1 (near-ties of NEAR_TIE counted) and
     to the oracle, at the default nprobe recall@10 (refined and not) no
     lower than phase 3's index's; right after phase 5's build: a
     ShardedFlatIndex on each mesh (K1 on each shard, the merged
     candidates re-ranked on the host), its top-10 on auto and on the
     exact product equal to phase 5's index's (K1 + K2; the exact
     product) and the oracle's, recall@10 >= 0.99; each with its
     build, batch-64 q/s and batch-1 p50 / p99; then
     sharded_engine_step on the 4-shard mesh over the 1M rows and
     DECAY_EDGES edges: top-10 against the oracle, the decay bit-equal
     to D1's plain version with the step's rule for days <= 0. Last,
     after 13-serve: Cortex with [embedding] sharded = true on SQLite
     and device=["cuda:0"] * 4 (MESH_NODES nodes, K1 on each shard)
     against a single-device Cortex by the reference's served criterion
     (the same hit set and top 1, the same scores; ids apart only where
     hashed text's scores tie) for searches and hybrid searches, and
     the same hits after a close and a reopen from its snapshot; then multichip.dryrun_multichip(4) on the
     virtual mesh (the engine step, the three routes, the 2 x 2 mesh and
     the composed server on both, held to a single-device engine). The
     numbers of a virtual mesh measure the per-shard programs and the
     merge run one after another on one card, not multi-GPU speed.
 15. the reference's cases on the card, after phase 14: (a) its model
     fuzz (tests/test_model_fuzz.py, seeds REF_FUZZ_SEEDS, 200 random
     stores, updates, deletes and searches each) through
     Cortex.in_memory(device="cuda") on the flat index with
     search_path "quant" (K1 + K2), held every 25 operations to a dict
     of live nodes: the stored live set, the index's membership, no dead
     id in a hit; (b) its IVF fuzz (tests/test_ivf_fuzz.py, seeds
     IVF_FUZZ_SEEDS) on TorchIvfIndex at nprobe = nlist: random upserts,
     updates, removes, retrains and filtered searches against the port's
     BruteForceIndex, the same ids (near-ties of NEAR_TIE counted) and
     scores within SCORE_ATOL; (c) exact-tie order: a TorchFlatIndex of
     TIE_ROWS rows, every row stored three times, the same TIE_QUERIES
     queries at each batch of TIE_BATCHES, the same ids in the same
     order, on the auto path (cap 4,096: K1 + K2) and on the exact
     product (cuBLAS); (d) entry.entry() on the card held to its CPU run
     (ids where no two scores lie within NEAR_TIE, scores within
     SCORE_ATOL).

Nine main paths: phases 3-4 (IVF, from the index's build, with 13's
IVF snapshot boot), 5-6 (flat, with 13's flat snapshot boot), 7-8
(graph, on the flat index), 9-10 (the linker), 11 (the encoder), 12
(the services), 13-serve (the server), 14 (the mesh) and 15 (a) to (c)
(reference-cases). Every launch
count is set to 0 just before each (and before each of phase 12's and
14's parts) and read just after it: probed_scores from the first,
fifth, sixth, eighth and ninth, block_knn from the first, eighth and
ninth (the IVF fuzz's graph builds),
quant_candidates from the first (the tuner's truth) to the ninth,
quant_rerank from the second to seventh and the ninth, frontier_bfs,
frontier_bfs_compact and bfs_relax from the third, decay_sweep from the
fourth and eighth, add_layer_norm, embed_layer_norm and
masked_attention from the fifth,
sixth and seventh, retention_eligibility from the sixth; launches made
in phase 2 (also its part at the 1M layout, inside phase 3), or to
compare a kernel with its plain version (or to time the forward or R1)
in phases 7-9, 11, 12 and 14 (the single-device index and Cortex
beside the mesh ones, the timed sweeps), do not count. The line
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
host ms per search in each of the program's search regions
(utils/tracing.py) and their self times, candidate rows per query,
device ms per kernel, and the device's idle share of the traced wall. The Chrome traces go to
profile_out/ beside this script. Last, on the flat index's planes, it
times K1's kernel whole and cut short after each of its parts, and K2
with its largest warp sort of 64, 256 and 1,024 entries, each from
csrc/flat_scan.cu built alone with a compile-time switch
(CORTEX_K1_PARTS, CORTEX_K2_WARP_SORT_MAX); before that, on the IVF
index's layout, N1 on 64 lists whole, cut after its product and after
its epilogue (CORTEX_KNN_PARTS), and whole with one consumer warpgroup
a block (CORTEX_KNN_WG, csrc/block_knn.cu). Then it traces
PROFILE_ROUNDS hybrid searches of phase 7's device tier (host ms per
leg, device ms per kernel, idle share), and times G2 from
csrc/graph_bfs.cu built alone, whole and cut after its table read
(CORTEX_RELAX_PARTS). Last, E1 and its embedding form at ENC_TIMED,
from csrc/encoder_rows.cu built alone with each launch form forced
(CORTEX_E1_FORM), beside the form the ops' build picks there.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import shutil
import statistics
import sys
import tempfile
import time
from dataclasses import replace
from urllib.parse import urlencode

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
# config #5's 10M edges cut for time (to 1M in PR 7, 500,000 in PR 14,
# 250,000 in PR 16 to make room for phase 15)
DECAY_STORE_EDGES, DECAY_STORE_NODES = 250_000, 25_000
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
E1_FORMS = (0, 1)                # csrc/encoder_rows.cu's launch forms
ENC_VOCAB = 30522                # BGE-small's (and BGE-base's) vocabulary
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
# R1 at the reference bench's 10M nodes (benches/decay_scale_bench.py) and
# at 1M; 14 B a node: 13 in (3 f32 + a bool), 1 out (a bool); a per-node
# parameter adds its 4 B (1 for protect_inbound)
RET_NODES, RET_CHUNK = 10_000_000, 1_000_000
RET_BYTES_PER_NODE, RET_PARAM_BYTES = 14, 4 * 4 + 1
RET_OPS_PER_NODE = 10       # 2 f32 subtracts, 2 multiplies, 6 compares
RET_NOW = 1.76e9            # epoch seconds: float32 ulp 128 s
# phase 12: gated stores on phase 11's flat Cortex and phase 4's IVF one,
# ungated ones beside them, briefings for SVC_AGENTS agents, retention
# over SVC_RET_NODES aged nodes with SVC_TOMBSTONES backdated tombstones
SVC_GATE_FLAT, SVC_GATE_IVF, SVC_UNGATED = 400, 200, 100
SVC_AGENTS, SVC_RET_NODES, SVC_TOMBSTONES = 24, 20_000, 200
SVC_SEARCHES = 20
GATE_NEAR_TIE = 1e-5      # scores this close to a threshold may decide apart
# R1's float32 epoch seconds against the engine's float64: 2 ulps of `now`
RET_BAND_S = 256.0
GRAPH_DEGREE = 32         # [embedding] ivf_graph_degree's default
GRAPH_WAIT_S = 600        # the background graph build must swap in by then
KNN_CHUNK = 64            # lists a chunk at the 1M layout (_chunk_clusters)
L_10M = 4096              # slots a list of the auto layout at 10M rows
# past the first N1 design's shared-memory strip (L <= 6,224 at d 768):
# lists of nlist's cap at ~40M rows and more
L_WIDE, WIDE_LISTS = 8192, 2
REFINE_NPROBES = (128, 16, 4, 1)   # recall with and without the graph
HARD_SPREAD = 1.0         # phase 3's hard queries: a row + 1.0 * noise
TUNE_TARGET = 0.95
# phase 13: rows mutated between the base and its delta link; graph rows
# compared by ids after a snapshot boot
SNAP_MUTATED, SNAP_GRAPH_ROWS = 1000, 20_000
SNAP_ROW_ATOL = 1e-6      # a saved unit row normalized once more at load
# the least share of rows a snapshot boot packs into their saved home
# list (the rest: lists that overflow at the repack's fill)
SNAP_HOME_SHARE = 0.99
# phase 13-serve: requests of each kind (gated POST /nodes, GET /search),
# ungated writes (the gate's override), searches held to the in-process
# search, concurrent clients and their rounds of searches
SERVE_REQUESTS, SERVE_UNGATED, SERVE_COMPARED = 200, 50, 50
SERVE_CONCURRENT, SERVE_CONCURRENT_ROUNDS = 64, 4
CLI_BOOT_S = 300          # `python -m cortex_tpu_torch serve` to /health
# phase 14: the virtual meshes on the one card (shards, replicas), the
# latency queries and batch-64 rounds of their speed, the Cortex's nodes
MESH_LAYOUTS = {"4": (4, 1), "2x2": (4, 2)}
MESH_LAT, MESH_RUNS, MESH_ROUNDS = 200, 3, 10
MESH_NODES, MESH_SEARCHES = 5000, 50
TUNE_QUERIES, TUNE_CAND = 256, 32   # K1 at the tuner's shape
# phase 15: the reference's model fuzz (its seeds, ops and check
# interval), its IVF fuzz (seeds, steps, width, lists) and the tie order
# of a flat index with every row stored three times, at each batch
REF_FUZZ_SEEDS, REF_FUZZ_OPS, REF_FUZZ_EVERY = (7, 99, 2026), 200, 25
IVF_FUZZ_SEEDS, IVF_FUZZ_STEPS = (0, 1, 2), 120
IVF_FUZZ_DIM, IVF_FUZZ_NLIST = 32, 8
TIE_ROWS, TIE_DIM, TIE_QUERIES, TIE_K = 3000, 384, 64, 10
TIE_BATCHES = (1, 7, 64)
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
    "embed_layer_norm": ("cortex_tpu_torch/csrc/encoder_rows.cu",
                         "cortex_tpu/models/encoder.py:236"),
    "masked_attention": ("cortex_tpu_torch/csrc/encoder_attn.cu",
                         "cortex_tpu/models/encoder.py:216"),
    "block_knn": ("cortex_tpu_torch/csrc/block_knn.cu",
                  "cortex_tpu/vector/knn_graph.py:105"),
    "retention_eligibility": (
        "cortex_tpu_torch/csrc/retention_eligibility.cu",
        "cortex_tpu/ops/decay.py:121"),
}


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def say(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def _wrappers():
    from cortex_tpu_torch.ops import (decay, encoder, graph_bfs, ivf_gather,
                                      knn_graph, similarity)
    return {"probed_scores": ivf_gather.probed_scores,
            "quant_candidates": similarity.quant_candidates,
            "quant_rerank": similarity.quant_rerank,
            "frontier_bfs": graph_bfs.frontier_bfs,
            "frontier_bfs_compact": graph_bfs.frontier_bfs_compact,
            "bfs_relax": graph_bfs.bfs_relax,
            "decay_sweep": decay.decay_sweep,
            "add_layer_norm": encoder.add_layer_norm,
            "embed_layer_norm": encoder.embed_layer_norm,
            "masked_attention": encoder.masked_attention,
            "block_knn": knn_graph.block_knn,
            "retention_eligibility": decay.retention_eligibility}


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
    bias = torch.from_numpy(co._search_filter(["k1"]).exact_bias()).to(dev)
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


# ------------------------------------------------ phase 2, N1


class KnnKernelCheck:
    """N1 (block_knn) against block_knn_plain: the lists equal, bit for
    bit (max_abs_err must stay 0)."""

    def __init__(self):
        self.max_abs_err = 0
        self.cases = 0

    def compare(self, emb, rinv, rows, mud, r):
        import torch
        from cortex_tpu_torch.ops.knn_graph import block_knn, block_knn_plain
        got = block_knn(emb, rinv, rows, mud, r)
        want = block_knn_plain(emb, rinv, rows, mud, r)
        torch.cuda.synchronize()
        check(got.shape == want.shape, "N1 and plain shapes differ")
        bad = int((got != want).sum())
        check(bad == 0, f"N1 differs from plain in {bad} list entries "
              f"(shape {tuple(emb.shape)}, r {r})")
        check(bool((want >= 0).any()), "N1 comparison saw no neighbour")
        self.cases += 1


def knn_inputs(dev, gen, c, l, d):
    """A synthetic layout (synthetic_layout) and its mud for a random mu."""
    import torch
    from cortex_tpu_torch.ops.knn_graph import slot_mu_dot
    emb, rinv, rows, _, _ = synthetic_layout(dev, gen, c, l, d)
    rinv = torch.where(rows >= 0, rinv, torch.zeros_like(rinv))
    mu = torch.randn(d, device=dev, generator=gen) * 0.02
    return emb, rinv, rows, slot_mu_dot(emb, rinv, mu)


def knn_timing(args, r):
    """N1 and its plain version timed on one chunk, beside the bound (the
    chunk's rows, rinv, slot_rows and mud read once, the lists written
    once; a list's L (L - 1) / 2 distinct dots of 2 d operations)."""
    from cortex_tpu_torch.ops.knn_graph import block_knn, block_knn_plain
    lists, slots, d = args[0].shape
    return timing(time_ms(lambda: block_knn(*args, r), 5),
                  time_ms(lambda: block_knn_plain(*args, r), 1),
                  bound_ms(lists * slots * (d + 12 + 4 * r),
                           lists * slots * (slots - 1) * d,
                           INT8_OPS_PER_S), lists=lists, slots=slots, r=r)


def check_knn_synthetic(knc, dev, gen):
    """Phase 2's N1 shapes: small and odd (L not a multiple of the 128-slot
    tile, d not of 16, a list with 3 live slots so r passes its live
    count), phase 4's 384-d layout at the default degree, the 10M auto
    layout's lists (L 4,096 at d 768) and WIDE_LISTS lists of L_WIDE at d
    768, past the first design's shared-memory limit (each from a
    generator of its own, so that the shared one draws as before), each
    timed beside its bound; returns the two timings."""
    import torch
    emb, rinv, rows, mud = knn_inputs(dev, gen, 5, 37, 100)
    rows[4, 3:] = -1
    emb[4, 3:] = 0
    rinv[4, 3:] = 0.0
    for r in (1, 12, 36):
        knc.compare(emb, rinv, rows, mud, r)
    knc.compare(*knn_inputs(dev, gen, 144, 192, DIM_NODES), GRAPH_DEGREE)
    out = {}
    for name, seed, lists, slots in (("l4096", 2, 4, L_10M),
                                     ("l8192", 3, WIDE_LISTS, L_WIDE)):
        own = torch.Generator(device=dev)
        own.manual_seed(seed)
        args = knn_inputs(dev, own, lists, slots, D_BIG)
        knc.compare(*args, GRAPH_DEGREE)
        out[name] = knn_timing(args, GRAPH_DEGREE)
        del args
    return out


def check_knn_real(knc, fc, index):
    """N1 on KNN_CHUNK lists of the 1M layout at r = the default degree
    and r = L - 1, and K1 at the tuner's shape (TUNE_QUERIES queries,
    cand TUNE_CAND, over the tuner's chunk of the flattened layout);
    timings beside their bounds. Launches here are not the main path's."""
    import torch
    from cortex_tpu_torch.ops.knn_graph import (block_knn, block_knn_plain,
                                                slot_mu_dot)
    from cortex_tpu_torch.ops.similarity import (quant_candidates,
                                                 quant_candidates_plain,
                                                 quantize_queries)
    from cortex_tpu_torch.vector.ivf import GATHER_BUDGET_BYTES
    co = index._corpus
    _, emb, rinv, rows, _, _ = co._ivf_dev
    c, l, d = emb.shape
    mu = torch.from_numpy(co._quant_mu).to(emb.device)
    blk, ri, sr = emb[:KNN_CHUNK], rinv[:KNN_CHUNK], rows[:KNN_CHUNK]
    mud = slot_mu_dot(blk, ri, mu)
    out = {}
    chunks = -(-c // KNN_CHUNK)
    # the int8 self-product alone ("product only": not the same function),
    # one list's block, times the C lists
    one = emb[0]
    product_ms = time_ms(lambda: torch._int_mm(one, one.T), 5) * c
    for r in (GRAPH_DEGREE, l - 1):
        knc.compare(blk, ri, sr, mud, r)
        # bytes: the chunk's rows, rinv, slot_rows and mud read once, the
        # lists written once; operations: a list's self-product is
        # symmetric, so it needs its L (L - 1) / 2 distinct dots of 2 d
        nbytes = KNN_CHUNK * l * (d + 12) + KNN_CHUNK * l * r * 4
        ops = KNN_CHUNK * l * (l - 1) * d
        ms = time_ms(lambda: block_knn(blk, ri, sr, mud, r), 5)
        t = timing(ms, time_ms(lambda: block_knn_plain(blk, ri, sr, mud, r),
                               1),
                   bound_ms(nbytes, ops, INT8_OPS_PER_S), lists=KNN_CHUNK,
                   layout_ms=ms * chunks, layout_chunks=chunks,
                   layout_int_mm_product_only_ms=product_ms)
        t["layout_bound_ms"] = t["bound_ms"] * chunks
        out[f"c{KNN_CHUNK}_r{r}"] = t
    # K1 as the tuner runs it: its first chunk of the flattened layout
    cc = max(1, min(c, GATHER_BUDGET_BYTES // (l * (d + 4 * TUNE_QUERIES))))
    q = torch.from_numpy(co._emb_h[np.flatnonzero(co._live_h)[
        :TUNE_QUERIES * 97:97]]).to(emb.device)
    qi8, qs = quantize_queries(q)
    flat_rows = rows[:cc].reshape(-1)
    bias = torch.where(flat_rows >= 0, 0.0, -1e30).to(torch.float32)
    args = (emb[:cc].reshape(-1, d), rinv[:cc].reshape(-1), qi8, qs, bias)
    fc.k1(*args, TUNE_CAND)
    cap = cc * l
    k1 = timing(time_ms(lambda: quant_candidates(*args, TUNE_CAND), 5),
                time_ms(lambda: quant_candidates_plain(*args, TUNE_CAND), 2),
                bound_ms(cap * (d + 8) + TUNE_QUERIES * d
                         + 8 * TUNE_QUERIES * TUNE_CAND,
                         2 * TUNE_QUERIES * cap * d, INT8_OPS_PER_S),
                rows=cap, int_mm_product_only_ms=time_ms(
                    lambda: torch._int_mm(qi8, args[0].T), 5))
    return out, k1


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


def noisy_centers(gen, centers, n, spread=0.35):
    """n unit queries, each a noisy copy (spread x unit-scale noise) of a
    random row of `centers`."""
    import torch
    d = centers.shape[1]
    sel = torch.randint(0, centers.shape[0], (n,), device=centers.device,
                        generator=gen)
    q = centers[sel] + spread * torch.randn((n, d), device=centers.device,
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


def wait_for_graph(index):
    """Wait for the background kNN-graph build to swap in; fail if it
    never does (a failed build is logged and leaves the graph off)."""
    co = index._corpus
    t0 = time.monotonic()
    while (co._graph_inflight and co._nbrs_h is None
           and time.monotonic() - t0 < GRAPH_WAIT_S):
        time.sleep(0.05)
    check(co._nbrs_h is not None, "the kNN graph never swapped in (see "
          "the log for the background build's error)")
    return time.monotonic() - t0


def phase_index(dev, n, d, gen, kc, knc=None, fc=None):
    """Phases 3 (build, the kNN graph at the default degree on its
    background thread) and 2 at the real layout (probed_scores; N1 and
    K1 at the tuner's shape when knc and fc are given, their launches
    uncounted); returns the index, the query sets, the timings and the
    rows (for phase 5)."""
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
    index._corpus.sync()                # k-means + pack + upload + spawn
    torch.cuda.synchronize()
    t_build = time.monotonic() - t0
    co = index._corpus
    c, l, _ = co._ivf_dev[1].shape
    graph_wait = wait_for_graph(index)
    gs = co._graph_stats
    check(gs.get("background") is True, "the 1M graph was not built on "
          "the background path")
    filled = float((co._nbrs_h[co._live_h] >= 0).sum(axis=1).mean())
    say("3-build", rows=n, dim=d, nlist=int(c), slots_per_list=int(l),
        nprobe=int(co._nprobe(c)), spill=bool(co._has_spill),
        gen_s=round(t_gen, 2), insert_s=round(t_insert, 2),
        build_s=round(t_build, 2), graph_degree=co._graph_degree,
        graph_wait_after_build_s=graph_wait, graph_wall_s=gs["wall_s"],
        graph_device_s=gs["device_s"], graph_fetch_s=gs["fetch_s"],
        graph_merge_s=gs["merge_s"], graph_chunks=gs["chunks"],
        graph_chunk_lists=gs["chunk_clusters"], graph_r=gs["r"],
        graph_mean_filled=filled,
        block_knn_launches=launch_counts()["block_knn"])
    q_np = noisy_centers(gen, centers, BATCH)
    q_lat = noisy_centers(gen, centers, N_LAT)
    with uncounted():
        perf, p = check_real_layout(kc, index, q_np)
        say("2-kernel-1M", nprobe=int(p), cases=kc.cases,
            max_abs_err=kc.max_abs_err, **perf)
        if knc is not None:
            knn, k1 = check_knn_real(knc, fc, index)
            perf = {"probed_scores": perf, "block_knn": knn,
                    "k1_tuner": k1}
            say("2-kernel-1M-knn", cases=knc.cases,
                max_abs_err=knc.max_abs_err, **knn, k1_tuner=k1)
    return index, q_np, q_lat, perf, (x_h, ids, kinds, q_np, member)


def search_speed(index, q_np, q_lat, refine=True, runs=QPS_RUNS,
                 rounds=QPS_ROUNDS):
    """Batch-64 queries/s (median of `runs` runs of `rounds` batches)
    and batch-1 latency in ms (p50, p99 over len(q_lat) queries), on the
    host clock around search_batch with k = K, after one untimed search
    of each shape (the first search loads the host re-rank library)."""
    index.search_batch(q_np, K, refine=refine)
    index.search_batch(q_lat[:1], K, refine=refine)
    qps = []
    for _ in range(runs):
        t0 = time.perf_counter()
        for _ in range(rounds):
            index.search_batch(q_np, K, refine=refine)
        qps.append(rounds * len(q_np) / (time.perf_counter() - t0))
    lat = []
    for b in range(len(q_lat)):
        t0 = time.perf_counter()
        index.search_batch(q_lat[b:b + 1], K, refine=refine)
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
        refined=True, recall_at_10=recall,
        batch64_qps_median=statistics.median(qps),
        batch64_qps_runs=qps, batch1_ms_p50=p50, batch1_ms_p99=p99,
        batch1_queries=len(q_lat), card=card)
    check(recall >= 0.9, f"default-nprobe recall@10 {recall} < 0.9")
    refine_report(index, q_np, q_lat, oi, truth, card)
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


def recall_at(index, q_np, truth, nprobe, refine):
    """recall@K of search_batch at `nprobe` against the oracle's sets."""
    co = index._corpus
    keep = co._nprobe_cfg
    co._nprobe_cfg = nprobe
    try:
        hits = index.search_batch(q_np, K, refine=refine)
    finally:
        co._nprobe_cfg = keep
    return float(np.mean([len({i for i, _ in h} & t) / K
                          for h, t in zip(hits, truth)]))


def refine_report(index, q_np, q_lat, oi, truth, card):
    """Phase 3 with the kNN graph on and off: recall@10 against the exact
    oracle at REFINE_NPROBES (refined never below unrefined), for phase
    3's queries and for hard ones (noisy copies of corpus rows,
    HARD_SPREAD, from a generator of their own so that the shared one
    draws as before), with the oracle rows that no probed list holds;
    and batch-1 latency and batch-64 throughput unrefined (3-search
    measured them refined)."""
    import torch
    co = index._corpus
    cent, slot_rows = co._ivf_dev[0], co._ivf_dev[3]
    hard_gen = torch.Generator(device=cent.device)
    hard_gen.manual_seed(1)
    pick = np.flatnonzero(co._live_h)[:BATCH * 997:997]
    q_hard = noisy_centers(hard_gen, torch.from_numpy(co._emb_h[pick]).to(
        cent.device), BATCH, spread=HARD_SPREAD)
    _, oi_hard = oracle_topk(co._emb_h, co._live_h, q_hard, K,
                             cent.device)
    truth_hard = [{co._id_of[r] for r in oi_hard[b][:K]}
                  for b in range(len(q_hard))]
    out = {}
    for name, qs, oracle, want in (("", q_np, oi, truth),
                                   ("hard_", q_hard, oi_hard, truth_hard)):
        for p in REFINE_NPROBES:
            on = recall_at(index, qs, want, p, True)
            off = recall_at(index, qs, want, p, False)
            check(on >= off, f"refined recall@10 {on} < unrefined {off} "
                  f"at nprobe {p} ({name or 'phase 3'} queries)")
            probed = torch.topk(torch.from_numpy(qs).to(cent.device)
                                @ cent.T, p, dim=1).indices
            held = [set(slot_rows[probed[b]].reshape(-1).cpu().numpy()
                        .tolist()) for b in range(len(qs))]
            missing = sum(1 for b in range(len(qs)) for r in oracle[b][:K]
                          if int(r) not in held[b])
            out[f"{name}nprobe{p}"] = {
                "recall_refined": on, "recall_unrefined": off,
                "oracle_rows_in_no_probed_list": missing}
    qps, p50, p99 = search_speed(index, q_np, q_lat, refine=False)
    say("3-refine", graph_degree=co._graph_degree, **out,
        unrefined_batch64_qps_median=statistics.median(qps),
        unrefined_batch64_qps_runs=qps, unrefined_batch1_ms_p50=p50,
        unrefined_batch1_ms_p99=p99, card=card)


def phase_tuned(dev, rows, card):
    """Phase 3's rows in a second index with ivf_target_recall =
    TUNE_TARGET: its build (sync, as the first search runs it) runs the
    nprobe tuner on the placed layout (K1 over the flattened layout for
    the truth, the probe-hit curve, then the delivered recall through the
    search) and spawns the kNN graph. Reports the pick, curve, delivered
    recall and candidate boost as index_info() publishes them, the
    build's wall, and recall@10 at the pick for phase 3's queries against
    the exact oracle, refined."""
    import torch
    from cortex_tpu_torch.vector.ivf import TorchIvfIndex
    x_h, ids, kinds, q_np, _ = rows
    index = TorchIvfIndex(x_h.shape[1], target_recall=TUNE_TARGET,
                          device=dev)
    index.insert_batch(ids, x_h, kinds=kinds)
    t0 = time.monotonic()
    index._corpus.sync()                # k-means + pack + tune + spawn
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    info = index.index_info()
    c = info["nlist"]
    check(info["nprobe_tuned"] > 0 and info["tune_curve"],
          f"the tuner picked no nprobe: {info}")
    check(info["nprobe"] == info["nprobe_tuned"],
          f"the index does not serve its tuned nprobe: {info}")
    check(info["delivered_recall"] is not None,
          "the tuner measured no delivered recall")
    wait_for_graph(index)
    info = index.index_info()
    check(info["graph_built"] and info["graph_error"] is None,
          f"the tuned index's graph is not serving: {info}")
    co = index._corpus
    _, oi = oracle_topk(co._emb_h, co._live_h, q_np, K, dev)
    truth = [{co._id_of[r] for r in oi[b][:K]} for b in range(len(q_np))]
    hits = index.search_batch(q_np, K)
    recall = float(np.mean([len({i for i, _ in h} & t) / K
                            for h, t in zip(hits, truth)]))
    say("3-tune", target_recall=TUNE_TARGET, nlist=c,
        nprobe_tuned=info["nprobe_tuned"], auto_nprobe=max(8, c // 8),
        tune_curve=info["tune_curve"],
        delivered_recall=info["delivered_recall"],
        cand_boost=info["cand_boost"], build_s=build_s,
        graph_built=info["graph_built"], recall_at_10_at_pick=recall,
        card=card)
    return index


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
    cfg.embedding.snapshot_boot = False       # the reopen times a rebuild
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


def phase_cortex_defaults(dev):
    """Phase 4 at the reference's IVF defaults: CortexConfig() with only
    index = "ivf" (ivf_graph_degree 32, nprobe auto, the default model:
    hashing without its weights on disk), in memory, N_NODES seeded
    nodes; then the same with ivf_target_recall = TUNE_TARGET. Searches
    run at the served nprobe through Cortex.search (decay off, so the
    hits are the index's fp32 scores). Held to the exact fp32 oracle
    over the host mirror: every hit scores its exact cosine, and every
    oracle top-K row that a probed list holds is returned (the graph may
    add rows no probed list holds; they are counted); a node's own text
    returns it first unless no probed list holds it. Returns the
    Cortex at the defaults, open, for phase 12's gated writes."""
    import torch
    from cortex_tpu_torch import Cortex
    from cortex_tpu_torch.config import CortexConfig
    from cortex_tpu_torch.vector.embedding import embedding_input
    nodes = seeded_nodes(N_NODES, seed=3)
    sample = nodes[:4000:100]
    out = {}
    for name, target in (("defaults", 0.0), ("target", TUNE_TARGET)):
        cfg = CortexConfig()
        cfg.embedding.index = "ivf"
        cfg.embedding.ivf_target_recall = target
        t0 = time.monotonic()
        cx = Cortex.in_memory(cfg, device=dev)
        cx.store_batch(nodes)
        texts = [embedding_input(n) for n in sample]
        got = [[(n.id, sc) for sc, n in cx.search(
            t, K, decay=False, record_access=False)] for t in texts]
        t_store = time.monotonic() - t0
        co = cx.index._corpus
        info = cx.index.index_info()
        check(co._graph_degree == GRAPH_DEGREE and co._nbrs_h is not None,
              f"{name}: the kNN graph is not serving")
        check(info["target_recall"] == target, f"{name}: target lost")
        if target > 0:
            check(info["nprobe_tuned"] > 0 and info["tune_curve"]
                  and info["delivered_recall"] is not None,
                  f"{name}: the tuner did not run: {info}")
        qv = np.stack([cx.embedder.embed(t) for t in texts]).astype(
            np.float32)
        qv /= np.linalg.norm(qv, axis=1, keepdims=True)
        ov, oi = oracle_topk(co._emb_h, co._live_h, qv, K, dev)
        cent, slot_rows = co._ivf_dev[0], co._ivf_dev[3]
        p = co._nprobe(int(cent.shape[0]))
        probed = torch.topk(torch.from_numpy(qv).to(cent.device) @ cent.T,
                            p, dim=1).indices
        recall, top1, stranded, via_graph = [], 0, 0, 0
        for b, (node, hits) in enumerate(zip(sample, got)):
            held = set(slot_rows[probed[b]].reshape(-1).cpu().numpy()
                       .tolist())
            ids = {nid for nid, _ in hits}
            for nid, sc in hits:
                exact = float(co._emb_h[co._row_of[nid]] @ qv[b])
                check(abs(sc - exact) <= SCORE_ATOL, f"{nid} rescored")
                check(sc <= ov[b][K - 1] + SCORE_ATOL or nid in {
                    co._id_of[r] for r in oi[b][:K]},
                      f"{nid} beats the exact top-{K}")
            for j, r in enumerate(oi[b][:K]):
                nid = co._id_of[int(r)]
                if int(r) in held:
                    check(nid in ids or abs(ov[b][j] - ov[b][K]) <= NEAR_TIE,
                          f"{name}: oracle rank {j} ({nid}) lies in a "
                          f"probed list but was not returned")
                elif nid in ids:
                    via_graph += 1
            recall.append(len(ids & {co._id_of[int(r)] for r in oi[b][:K]})
                          / K)
            if hits and hits[0][0] == node.id:
                top1 += 1
            else:
                check(co._row_of[node.id] not in held,
                      f"{name}: {node.id} lies in a probed list but is not "
                      f"its own top-1")
                stranded += 1
        out[name] = {"nlist": info["nlist"], "nprobe": p,
                     "nprobe_tuned": info["nprobe_tuned"],
                     "tune_curve": info["tune_curve"],
                     "delivered_recall": info["delivered_recall"],
                     "cand_boost": info["cand_boost"],
                     "recall_at_10": float(np.mean(recall)),
                     "self_top1": top1, "stranded": stranded,
                     "oracle_rows_via_graph": via_graph,
                     "open_store_search_s": t_store}
        if target > 0:
            cx.close()
        else:
            defaults = cx
    say("4-cortex-defaults", nodes=N_NODES, searches=len(sample), **out)
    return defaults


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
    host = torch.from_numpy(co._search_filter(
        exclude_ids=[co._id_of[r] for r in range(0, 20000, 97)]
    ).exact_bias()).to(emb.device)
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
            bound_ms(nbytes, 2 * b * cap * d, INT8_OPS_PER_S),
            int_mm_product_only_ms=time_ms(
                lambda: torch._int_mm(qib, emb_i8.T), 5))
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
    cfg.embedding.snapshot_boot = False       # the reopen times a rebuild
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
        # spans (these, and the program's search regions) have a
        # device-side range over the kernels they launched: left out
        if e.key.startswith(("H0.", "H1.", "H2.", "search.")):
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


class RetentionCheck:
    """R1 against retention_eligibility_plain on the same card: the masks
    bit-equal (the kernel spells the plain version's float32 subtract
    and multiply by float32(1 / 86400) with __fsub_rn / __fmul_rn).
    max_abs_err (nodes whose mask differs) must stay 0."""

    def __init__(self):
        self.max_abs_err = 0.0
        self.cases = 0

    def compare(self, nodes, params):
        import torch
        from cortex_tpu_torch.ops import decay
        got = decay.retention_eligibility(*nodes, *params)
        want = decay.retention_eligibility_plain(
            *decay._retention_args(*nodes, *params))
        torch.cuda.synchronize()
        diff = int((got != want).sum())
        check(got.dtype == torch.bool and got.shape == want.shape
              and diff == 0, f"R1 differs from plain on {diff} nodes")
        self.cases += 1
        return got


def retention_kernel_inputs(dev, gen, n, per_node=False):
    """Seeded node arrays on the card (ages 0-80 days, idle 0-40 days at
    RET_NOW) with rows exactly on the TTL (30 days), grace (10 days) and
    score (0.4) boundaries; the five parameters as 0-d tensors, or one a
    node (ttl 0 and min_score < 0 on some rows)."""
    import torch

    def rand():
        return torch.rand(n, device=dev, generator=gen)

    now = torch.tensor(RET_NOW, dtype=torch.float32, device=dev)
    created = now - rand() * (80 * 86400.0)
    last = now - rand() * (40 * 86400.0)
    score = rand()
    inbound = rand() < 0.3
    created[::97] = now - 30 * 86400.0
    last[::89] = now - 10 * 86400.0
    score[::83] = 0.4
    nodes = [created, last, score, inbound]
    if not per_node:
        return nodes, [now] + [torch.tensor(v, device=dev) for v in (
            30.0, 10.0, 0.4)] + [torch.tensor(True, device=dev)]

    def pick(values):
        v = torch.tensor(values, dtype=torch.float32, device=dev)
        return v[torch.randint(0, len(values), (n,), device=dev,
                               generator=gen)]

    return nodes, [now.expand(n).contiguous(), pick([0.0, 20.0, 30.0, 60.0]),
                   pick([0.0, 10.0, 30.0]), pick([-1.0, 0.2, 0.4, 0.7]),
                   rand() < 0.5]


def check_retention(rc, dev, gen, card):
    """Phase 2 for R1: small odd sizes, then RET_NODES (the reference
    bench's 10M) made on the card, each with the parameters broadcast
    and one a node; the kernel's and plain version's times at 10M and
    1M beside the bound in bytes (RET_BYTES_PER_NODE a node, plus
    RET_PARAM_BYTES with per-node parameters). No single PyTorch call
    computes this mask (library_ms null)."""
    import torch
    from cortex_tpu_torch.ops import decay
    for n in (1, 31, 65_537):
        for per_node in (False, True):
            rc.compare(*retention_kernel_inputs(dev, gen, n, per_node))
    perf, flags = {}, {}
    for per_node in (False, True):
        nodes, params = retention_kernel_inputs(dev, gen, RET_NODES,
                                                per_node)
        got = rc.compare(nodes, params)
        key = "per_node" if per_node else "broadcast"
        flags[key] = int(got.sum())
        check(0 < flags[key] < RET_NODES,
              f"the 10M {key} mask is all one value")
        sizes = ((("n10M", RET_NODES), ("n1M", RET_CHUNK)) if not per_node
                 else (("n10M_per_node", RET_NODES),))
        for name, n in sizes:
            a = [t[:n] for t in nodes]
            pa = [t if t.dim() == 0 else t[:n] for t in params]
            plain = decay._retention_args(*a, *pa)
            nbytes = (RET_BYTES_PER_NODE
                      + (RET_PARAM_BYTES if per_node else 0)) * n
            perf[name] = timing(
                time_ms(lambda: decay.retention_eligibility(*a, *pa), 20),
                time_ms(lambda: decay.retention_eligibility_plain(*plain),
                        5),
                bound_ms(nbytes, RET_OPS_PER_NODE * n, F32_OPS_PER_S),
                library_ms=None)
        del nodes, params, got
    say("2-retention", cases=rc.cases, max_abs_err=rc.max_abs_err,
        nodes=RET_NODES, eligible=flags, card=card,
        real_size="10M nodes: the reference's decay_scale_bench scale",
        **perf)
    torch.cuda.empty_cache()
    return perf


# ------------------------------------------------------ phase 2, encoder


def e1_form(embed, ids64, rows, h):
    """The launch form (csrc/encoder_rows.cu's note) E1, or with `embed`
    its embedding form (int64 ids with `ids64`), takes over rows x h
    values on the current device."""
    import ctypes
    from cortex_tpu_torch.ops import build
    fn = ctypes.CDLL(str(build.build_library())).cortex_encoder_rows_form
    fn.argtypes = (ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int)
    form = fn(int(embed), int(ids64), rows, h)
    check(form >= 0, f"E1: no launch form for {rows} x {h}")
    return form


class EncoderKernelCheck:
    """E1 and E2 against their plain versions on the same card, within
    LN_ATOL and ATTN_ATOL; keeps the largest difference of each, and of
    E1 and its embedding form also by the launch form each case took;
    checks E2's padding invariance bit for bit. E2 at large |q| and |k|
    is held to the float64 answer instead (e2_scaled)."""

    def __init__(self):
        self.e1_err = self.e2_err = self.emb_err = 0.0
        self.e1_cases = self.e2_cases = self.emb_cases = 0
        self.forms = {"add_layer_norm": {}, "embed_layer_norm": {}}
        self.invariant_rows = 0
        self.scaled = []

    def _by_form(self, name, form, err):
        cases, worst = self.forms[name].get(form, (0, 0.0))
        self.forms[name][form] = (cases + 1, max(worst, err))

    def forms_held(self):
        """{kernel: {"form<n>": {"cases", "max_abs_err"}}}, after
        checking that the cases reached every launch form of each."""
        for name, seen in self.forms.items():
            check(sorted(seen) == list(E1_FORMS),
                  f"{name}'s checks reached forms {sorted(seen)} only")
        return {name: {f"form{f}": {"cases": c, "max_abs_err": e}
                       for f, (c, e) in sorted(seen.items())}
                for name, seen in self.forms.items()}

    def e1(self, x, r, g, b):
        import torch
        from cortex_tpu_torch.ops import encoder as enc
        got = enc.add_layer_norm(x, r, g, b, ENC_EPS)
        want = enc.add_layer_norm_plain(x, r, g, b, ENC_EPS)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(err <= LN_ATOL, f"E1 differs from plain by {err} at "
              f"{tuple(x.shape)}")
        self._by_form("add_layer_norm", e1_form(False, False, *x.shape), err)
        self.e1_err = max(self.e1_err, err)
        self.e1_cases += 1

    def emb(self, ids, word, pos, type_row, g, b):
        """E1's embedding form against its plain version, within
        LN_ATOL."""
        import torch
        from cortex_tpu_torch.ops import encoder as enc
        got = enc.embed_layer_norm(ids, word, pos, type_row, g, b, ENC_EPS)
        want = enc.embed_layer_norm_plain(ids, word, pos, type_row, g, b,
                                          ENC_EPS)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(err <= LN_ATOL, f"the embedding form differs from plain by "
              f"{err} at ids {tuple(ids.shape)}, h {word.shape[1]}")
        self._by_form("embed_layer_norm", e1_form(
            True, ids.dtype == torch.int64, ids.numel(), word.shape[1]), err)
        self.emb_err = max(self.emb_err, err)
        self.emb_cases += 1

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


def embed_tables(dev, gen, h, vocab=ENC_VOCAB, positions=512):
    """The embedding form's word [vocab, h] and pos [positions, h]
    tables, type row, gain and bias, seeded."""
    import torch
    return (torch.randn(vocab, h, device=dev, generator=gen) * 0.5,
            torch.randn(positions, h, device=dev, generator=gen) * 0.5,
            torch.randn(h, device=dev, generator=gen) * 0.5,
            1.0 + 0.1 * torch.randn(h, device=dev, generator=gen),
            0.1 * torch.randn(h, device=dev, generator=gen))


def embed_ids(dev, gen, b, s, vocab=ENC_VOCAB, dtype=None, edges=False):
    """[b, s] token ids drawn from the vocabulary; with `edges` the first
    ids are 0, vocab - 1 and ids past both ends of the table (which the
    gather clamps, as the reference's does)."""
    import torch
    ids = torch.randint(0, vocab, (b, s), device=dev, generator=gen,
                        dtype=dtype or torch.int32)
    if edges:
        flat = ids.view(-1)
        out = torch.tensor([0, vocab - 1, vocab, vocab + 7, -1, -vocab - 2],
                           dtype=ids.dtype, device=dev)[:flat.numel()]
        flat[:len(out)] = out
    return ids


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
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for h in (36, 384, 768):                    # small, BGE-small, dh 64
        for s in ENC_CHECK_SEQS:                # T = 3 * S: 3, 93 odd
            x, r, g, b = ln_inputs(dev, gen, 3 * s, h, 3 * s)
            ec.e1(x, r, g, b)
            ec.e1(x, r[:s], g, b)               # an [S, h] residual
        # E1's launch shape switches at 2 and 4 x the SM count
        for t in (2 * sms - 1, 2 * sms, 4 * sms - 1, 4 * sms):
            ec.e1(*ln_inputs(dev, gen, t, h, t))
        tables = embed_tables(dev, gen, h)
        for s in ENC_CHECK_SEQS:
            for dtype in (torch.int32, torch.int64):
                ec.emb(embed_ids(dev, gen, 3, s, dtype=dtype, edges=True),
                       *tables)
        # positions past P clamp to P - 1
        ec.emb(embed_ids(dev, gen, 2, 100, edges=True), tables[0],
               tables[1][:64], *tables[2:])
        del tables
    # the shapes timed below, where the large T take the other forms
    for b, s, h, _ in ENC_TIMED.values():
        ec.e1(*ln_inputs(dev, gen, b * s, h, b * s))
        ec.emb(embed_ids(dev, gen, b, s, edges=True), *embed_tables(dev, gen, h))
        torch.cuda.empty_cache()
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
    perf = {"add_layer_norm": {}, "embed_layer_norm": {},
            "masked_attention": {}}
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
        perf["embed_layer_norm"][name] = time_embed(dev, gen, b, s, h)
        perf["masked_attention"][name] = time_attention(
            dev, gen, b, s, h, heads, "uniform")
    say("2-encoder", e1_cases=ec.e1_cases, e1_max_abs_err=ec.e1_err,
        e1_atol=LN_ATOL, embed_cases=ec.emb_cases,
        embed_max_abs_err=ec.emb_err, by_launch_form=ec.forms_held(),
        e1_host_us=e1_host_us(dev, gen),
        e2_cases=ec.e2_cases, e2_max_abs_err=ec.e2_err,
        e2_atol=ATTN_ATOL, e2_padding_invariant_rows=ec.invariant_rows,
        e2_scaled=ec.scaled, e2_scale=ENC_ATTN_SCALE,
        card=card, **{f"{k}_{shape}": v for k, t in perf.items()
                      for shape, v in t.items()})
    return perf


def embed_sets(dev, gen, b, s, h):
    """`rotating` input sets of the embedding form at one shape, whose
    ids gather from copies of a BGE-sized word table that together
    exceed the L2 four times; and the number of those tables."""
    table_bytes = 4 * ENC_VOCAB * h
    tables = [embed_tables(dev, gen, h)
              for _ in range(-(-4 * L2_BYTES // table_bytes))]
    n = itertools.count()

    def embed_set():
        ids = embed_ids(dev, gen, b, s)
        word, pos, type_emb, g, bb = tables[next(n) % len(tables)]
        return ids, word, pos, type_emb, g, bb
    return rotating(embed_set, 4 * b * s + 8 * b * s * h), len(tables)


def time_embed(dev, gen, b, s, h):
    """E1's embedding form at one shape: its, its plain version's and the
    three launches' it replaces (F.embedding, the [S, h] position + type
    add, E1) times, over `embed_sets`; the bound in bytes: the ids, the
    distinct rows they gather, the S position rows, the type row, g and
    b read once and y written once. No single PyTorch call computes it
    (library_ms null)."""
    import torch
    import torch.nn.functional as F
    from cortex_tpu_torch.ops import encoder as enc
    t = b * s
    sets, n_tables = embed_sets(dev, gen, b, s, h)

    def replaced(ids, word, pos, type_row, g, bb):
        x = F.embedding(ids, word).view(t, h)
        return enc.add_layer_norm(x, pos[:s] + type_row, g, bb, ENC_EPS)
    distinct = float(np.mean([int(torch.unique(st[0]).numel())
                              for st in sets]))
    nbytes = 4 * t + 4 * h * (distinct + s + 3 + t)
    out = timing(
        time_rotating(lambda *a: enc.embed_layer_norm(*a, ENC_EPS), sets,
                      50),
        time_rotating(lambda *a: enc.embed_layer_norm_plain(*a, ENC_EPS),
                      sets, 20),
        bound_ms(nbytes, 9 * t * h, F32_OPS_PER_S), library_ms=None,
        replaced_ms=time_rotating(replaced, sets, 50), shape=[b, s, h],
        distinct_ids=distinct, input_sets=len(sets), word_tables=n_tables)
    del sets
    torch.cuda.empty_cache()
    return out


def host_us(fn, calls=10_000):
    """Host microseconds of one fn() call: the wall of `calls` calls
    (time.perf_counter) over calls, the device idle before and kept
    ahead of (each call's kernel is shorter than its enqueue)."""
    import torch
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    out = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return out


def e1_host_us(dev, gen):
    """host_us of one E1 call and one embedding-form call at B 1 / S 32
    (h 384) on tensors as a layer holds them (contiguous, 16-byte
    aligned)."""
    from cortex_tpu_torch.ops import encoder as enc
    x, r, g, b = ln_inputs(dev, gen, 32, 384, 32)
    ids, tables = embed_ids(dev, gen, 1, 32), embed_tables(dev, gen, 384)
    return {"add_layer_norm": host_us(
                lambda: enc.add_layer_norm(x, r, g, b, ENC_EPS)),
            "embed_layer_norm": host_us(
                lambda: enc.embed_layer_norm(ids, *tables, ENC_EPS))}


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
    DECAY_STORE_EDGES edges (config #5's 10M cut for time), in
    process (D1 launched once: one chunk) and through
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
    batch 1. Spans: L0 search_batch (the whole search, this function's),
    and the program's own regions (utils/tracing.py), which record while
    the profiler runs: search.dispatch (search.prepare, search.launch)
    and search.finish (search.fetch: the copy that waits for the device;
    search.expand, search.rerank, search.hits), with their self times
    and the counters per query. Device time sums the kernels' own rows
    (a span's device-side range is left out: it covers the kernels it
    launched), so the idle share is 1 - busy / wall."""
    from pathlib import Path
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    import torch
    from cortex_tpu_torch.utils import tracing
    out_dir = Path(__file__).resolve().parent / "profile_out"
    out_dir.mkdir(exist_ok=True)
    for label, batches in (("batch64", [q_np] * PROFILE_ROUNDS),
                           ("batch1", [q_lat[b:b + 1]
                                       for b in range(PROFILE_ROUNDS)])):
        for q in batches[:3]:
            index.search_batch(q, K)
        torch.cuda.synchronize()
        tracing.reset_counters()
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
            if e.key.startswith(("L0.", "search.")):
                if e.device_type != DeviceType.CUDA:
                    host[e.key] = e.cpu_time_total / 1e3 / len(batches)
            elif e.device_type == DeviceType.CUDA:
                dev[e.key[:80]] = e.self_device_time_total / 1e3 / len(
                    batches)
        selfs = tracing.self_times()
        queries = tracing.counters().get("search.queries", 0)
        busy = sum(dev.values())
        say(f"profile-{name}-{label}", rounds=len(batches),
            traced_wall_ms=wall, device_busy_ms=busy,
            device_idle_share=1 - busy / wall, host_ms=host,
            self_ms={k: v * 1e3 / len(batches) for k, v in selfs.items()
                     if k.startswith("search.")},
            rows_per_query={k: v / max(1, queries) for k, v in
                            tracing.counters().items()
                            if k.endswith("_rows")},
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


def profile_knn_parts(index, card):
    """N1 alone (csrc/block_knn.cu) on the first KNN_CHUNK lists of phase
    3's layout at r = the default degree: whole (CORTEX_KNN_PARTS = 0,
    whose lists must equal the op's), cut after the product (1: no
    epilogue, no selection), and after the epilogue's threshold tests
    (2: nothing staged or selected); then whole with one consumer
    warpgroup a block (CORTEX_KNN_WG = 1: 64-row tiles, two blocks an
    SM) against the ops' two (128-row tiles)."""
    import ctypes
    import torch
    from cortex_tpu_torch.ops.knn_graph import block_knn, slot_mu_dot
    parts, secs = build_variants("CORTEX_KNN_PARTS", (0, 1, 2),
                                 "block_knn.cu")
    wgs, wg_secs = build_variants("CORTEX_KNN_WG", (1,), "block_knn.cu")
    co = index._corpus
    _, emb, rinv, rows, _, _ = co._ivf_dev
    blk, ri, sr = emb[:KNN_CHUNK], rinv[:KNN_CHUNK], rows[:KNN_CHUNK]
    mud = slot_mu_dot(blk, ri, torch.from_numpy(co._quant_mu).to(emb.device))
    c, l, d = blk.shape
    r = GRAPH_DEGREE
    want = block_knn(blk, ri, sr, mud, r)
    out = torch.empty_like(want)
    ptr = ctypes.c_void_p
    stream = ptr(torch.cuda.current_stream().cuda_stream)
    res = {}
    for lib, name in ((parts[0], "whole"), (parts[1], "product_only"),
                      (parts[2], "product_epilogue"),
                      (wgs[1], "whole_one_warpgroup")):
        lib.cortex_block_knn_scratch.restype = ctypes.c_longlong
        nb = lib.cortex_block_knn_scratch(c, l, d, r, 1)
        check(nb >= 0, "N1 variants: device query failed")
        scratch = torch.empty(max(nb, 1), dtype=torch.uint8,
                              device=emb.device)

        def run(lib=lib, nb=nb, scratch=scratch):
            check(lib.cortex_block_knn_launch(
                ptr(blk.data_ptr()), ptr(ri.data_ptr()), ptr(sr.data_ptr()),
                ptr(mud.data_ptr()), ptr(out.data_ptr()),
                ptr(scratch.data_ptr() if nb > 0 else 0), c, l, d, r, 1,
                stream) == 0, "N1 variants: launch failed")
        if name.startswith("whole"):
            run()
            torch.cuda.synchronize()
            check(torch.equal(out, want), f"N1 variant {name} differs from "
                  f"the op")
        res[f"{name}_ms"] = time_ms(run, 5)
    say("profile-knn-parts", card=card, lists=c, slots=l, dim=d, r=r,
        nvcc_s={**secs, "wg1": wg_secs[1]}, **res)


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


def profile_e1_forms(dev, gen, card):
    """E1 and its embedding form at ENC_TIMED from csrc/encoder_rows.cu
    built alone, one library for each launch form forced at every T
    (CORTEX_E1_FORM), timed over `rotating` and `embed_sets` input sets
    as phase 2 times the ops' build, beside the form that build picks at
    each shape."""
    import ctypes
    import torch
    libs, _ = build_variants("CORTEX_E1_FORM", E1_FORMS,
                             source="encoder_rows.cu")
    ptr, i64, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
    stream = ptr(torch.cuda.current_stream().cuda_stream)
    out = {}
    for name, (b, s, h, _) in ENC_TIMED.items():
        t = b * s
        y = torch.empty(t, h, device=dev)
        row = {"picked": {"add_layer_norm": e1_form(False, False, t, h),
                          "embed_layer_norm": e1_form(True, False, t, h)}}
        sets = rotating(lambda: ln_inputs(dev, gen, t, h, t), 4 * 3 * t * h)
        for form, lib in libs.items():
            def e1(x, r, g, bb, lib=lib):
                check(lib.cortex_add_layer_norm_launch(
                    *(ptr(v.data_ptr()) for v in (x, r, g, bb)), i64(t), h,
                    i64(t), f32(ENC_EPS), ptr(y.data_ptr()), stream) == 0,
                    "E1 forms: launch failed")
            row[f"e1_form{form}_ms"] = time_rotating(e1, sets, 50)
        sets, _ = embed_sets(dev, gen, b, s, h)
        for form, lib in libs.items():
            def emb(ids, word, pos, type_row, g, bb, lib=lib):
                check(lib.cortex_embed_layer_norm_launch(
                    ptr(ids.data_ptr()), 0, *(ptr(v.data_ptr()) for v in (
                        word, pos, type_row, g, bb)), i64(t), i64(s),
                    i64(word.shape[0]), i64(pos.shape[0]), h, f32(ENC_EPS),
                    ptr(y.data_ptr()), stream) == 0,
                    "embedding form, forms: launch failed")
            row[f"embed_form{form}_ms"] = time_rotating(emb, sets, 50)
        del sets, y
        torch.cuda.empty_cache()
        out[name] = row
    say("profile-e1-forms", card=card, **out)


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
    """One traced forward at B = 1, S = 32 (a store or a search), one at
    B = 64, S = 128, one at the embedder's S = 512 chunk with every key
    kept and one at that chunk with phase 11's lengths (attn_mask's
    "mix"): device ms by kernel, its kernel launches (memory copies
    apart) and the launches of E1, its embedding form and E2 (their
    counts), the shares of the products (cuBLAS gemm kernels), E1, the
    embedding form, E2, GELU and the rest of the device time, and beside
    them the host ms of the same forward untraced (time.perf_counter
    around embed_tokens and its synchronize, the median of 20 calls, 3
    at the S 512 chunk)."""
    import torch
    out = {}
    rows = emb.chunk_rows(512)
    gen = torch.Generator()
    gen.manual_seed(ENC_SEED)
    for b, s, mix in ((1, 32, False), (64, 128, False), (rows, 512, False),
                      (rows, 512, True)):
        ids = np.random.default_rng(s).integers(
            1000, cfg.vocab_size, (b, s)).astype(np.int32)
        mask = np.ones((b, s), np.int32)
        if mix:
            mask = attn_mask("cpu", gen, b, s, "mix")[1].numpy().astype(
                np.int32)
        host = host_ms(lambda: emb.embed_tokens(ids, mask),
                       3 if s == 512 else 20)
        before = launch_counts()
        dev_ms, launches = traced(lambda: emb.embed_tokens(ids, mask))
        ours = {n: c - before[n] for n, c in launch_counts().items()
                if c > before[n]}
        total = sum(dev_ms.values())
        check(total > 0, "the profiler saw no device time")
        check(ours.get("embed_layer_norm") == 1
              and ours.get("add_layer_norm") == 2 * cfg.layers,
              f"a forward launched {ours}")
        parts = {"gemm": ("gemm",), "e1": ("add_ln_",),
                 "embed": ("embed_ln_",),
                 "e2": ("masked_attention_tc_kernel",), "gelu": ("gelu",)}
        share = {p: sum(v for k, v in dev_ms.items()
                        if any(m in k.lower() for m in marks)) / total
                 for p, marks in parts.items()}
        share["other"] = 1 - sum(share.values())
        out[f"b{b}_s{s}" + ("_mix" if mix else "")] = {
            "device_ms": total, "launches": launches,
            "wrapper_launches": ours,
            "host_ms": host, "share": share,
            "kernels": len(dev_ms), "kept_tokens": int(mask.sum())}
    return out


def host_ms(fn, reps):
    """The median host ms of fn() followed by a synchronize, over reps
    calls after one more."""
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def traced(fn):
    """fn() once under torch.profiler: device ms by kernel name, and the
    kernel launches (memory copies and sets apart)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    return ({e.key: e.self_device_time_total / 1e3 for e in events},
            sum(e.count for e in events
                if not e.key.lower().startswith(("memcpy", "memset"))))


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


# ------------------------------------------------------------ phase 12


class ExactGateIndex:
    """The gate's conflict search as an exact fp32 numpy top-k over the
    stored embeddings (VectorIndex's `search` signature); `add` takes a
    write the gate let through. last_scores holds the last search's."""

    def __init__(self, ids, x):
        self.ids = list(ids)
        self.x = np.asarray(x, np.float32)
        self.n = len(self.ids)
        self.last_scores = np.zeros(0)
        self.probe_tie = False

    def add(self, nid, v):
        if self.n == len(self.x):
            self.x = np.concatenate([self.x, np.zeros_like(self.x)])
        self.x[self.n] = v
        self.ids.append(nid)
        self.n += 1

    def search(self, vector, k, flt=None, *, refine=True):
        s = self.x[:self.n] @ np.asarray(vector, np.float32)
        top = np.argsort(-s, kind="stable")[:k]
        self.last_scores = s[top]
        return [(self.ids[i], float(s[i])) for i in top]


class ProbedGateIndex:
    """The IVF gate's search as the index defines it: the exact fp32
    scores (the corpus's host mirror) of every live row that the query's
    nprobe lists hold, top k. probe_tie: the query's p-th and (p + 1)-th
    centroid scores lie within GATE_NEAR_TIE, so the probed set itself
    is ambiguous."""

    def __init__(self, corpus):
        self.co = corpus
        self.last_scores = np.zeros(0)
        self.probe_tie = False

    def search(self, vector, k, flt=None, *, refine=True):
        import torch
        co = self.co
        cent, slot_rows = co._ivf_dev[0], co._ivf_dev[3]
        p = co._nprobe(int(cent.shape[0]))
        v = np.asarray(vector, np.float32)
        cs = cent @ torch.from_numpy(v).to(cent.device)
        best = torch.topk(cs, min(p + 1, len(cs)))
        top = best.values.cpu().numpy()
        self.probe_tie = bool(len(top) > p
                              and top[p - 1] - top[p] <= GATE_NEAR_TIE)
        rows = slot_rows[best.indices[:p]].reshape(-1).cpu().numpy()
        rows = np.unique(rows[rows >= 0])
        rows = rows[co._live_h[rows]]
        s = co._emb_h[rows] @ v
        order = np.argsort(-s, kind="stable")[:k]
        self.last_scores = s[order]
        return [(co._id_of[int(rows[i])], float(s[i])) for i in order]


def gate_near_tie(scores, cfg, kind):
    """Whether a searched score lies within GATE_NEAR_TIE of a threshold
    the conflict check compares it with, or two scores past the lower
    threshold lie that close (the node it reports may then differ)."""
    ov = cfg.overrides.get(kind)
    conflict = (ov.conflict_threshold if ov and ov.conflict_threshold
                is not None else cfg.conflict_threshold)
    s = np.asarray(scores, np.float64)
    if not len(s):
        return False
    for t in (cfg.duplicate_threshold, conflict):
        if np.abs(s - t).min() <= GATE_NEAR_TIE:
            return True
    hot = np.sort(s[s > min(cfg.duplicate_threshold, conflict)])
    return bool(len(hot) > 1 and np.diff(hot).min() <= GATE_NEAR_TIE)


def gate_candidates(stored, fresh, n, seed):
    """n gated writes in a seeded order: half re-submit a stored node's
    text under a new id (another agent, importance 0.5): planted
    duplicates, which the conflict check must reject; a sixth are
    same-kind near copies by another agent (two body words taken from
    another node: contradictions or duplicates); a twelfth fail
    substance (a short title or body) or specificity (relative time, or
    importance 0.9 without tags); the rest are fresh. Stored decisions
    are not re-submitted: their made-up bodies lack the decision words,
    so substance rejects them first."""
    from cortex_tpu_torch.types import Node, Source
    rng = np.random.default_rng(seed)
    pool = [m for m in stored if m.kind not in ("decision", "pattern")]
    picks = rng.choice(len(pool), n, replace=False)
    n_dup, n_near, n_bad = n // 2, n // 6, n // 12
    out, planted = [], set()
    for j in range(n_dup):
        m = pool[picks[j]]
        node = Node.new(m.kind, m.title, m.body, Source(agent="resubmit"),
                        0.5)
        planted.add(node.id)
        out.append(node)
    for j in range(n_dup, n_dup + n_near):
        m, o = pool[picks[j]], pool[picks[-1 - j]].body.split()
        words = m.body.split()
        for w in (1, 3):
            words[w % len(words)] = o[w % len(o)]
        out.append(Node.new(m.kind, m.title, " ".join(words),
                            Source(agent="near-copy"), 0.5))
    for j in range(n_bad):
        m = pool[picks[n_dup + n_near + j]]
        title, body, imp = m.title, m.body, 0.5
        if j % 4 == 0:
            title = "Short"
        elif j % 4 == 1:
            body = "tiny body"
        elif j % 4 == 2:
            title = f"What happened yesterday: {m.title}"
        else:
            imp = 0.9
        out.append(Node.new(m.kind, title, body, Source(agent="bad"), imp))
    fresh = [m for m in fresh if m.kind not in ("decision", "pattern")]
    for m in fresh[:n - len(out)]:
        out.append(Node.new(m.kind, m.title, m.body, Source(agent="fresh"),
                            0.5))
    check(len(out) == n, f"{len(out)} gate candidates, not {n}")
    return [out[i] for i in rng.permutation(n)], planted


def gate_pass(cx, candidates, planted, oracle, exact=None):
    """Each candidate through cx.store(gate=True), timed; its decision
    (check, existing node) against WriteGate.check_all with the same
    embedding over `oracle` (and, for the IVF index, over the exact
    index `exact`, counting where the probed lists decide otherwise).
    Decisions may differ only at a near-tie (gate_near_tie, or an
    ambiguous probe set), and those are counted. Every planted
    duplicate must be rejected by the conflict check (on the IVF index,
    every one whose original a probed list holds): the gate swallows
    search errors, so this is what shows that its device search ran."""
    from cortex_tpu_torch.errors import GateRejection
    from cortex_tpu_torch.gate import WriteGate
    counts = {"stored": 0, "conflict_duplicate": 0,
              "conflict_contradiction": 0, "substance": 0,
              "specificity": 0, "schema": 0, "near_ties": 0,
              "differ_at_near_tie": 0, "planted_rejected": 0,
              "planted_unprobed": 0, "differ_from_exact": 0}
    ms = []
    wg = cx.config.write_gate
    for node in candidates:
        t0 = time.perf_counter()
        try:
            cx.store(node, gate=True)
            got, reason = None, ""
        except GateRejection as e:
            got, reason = (e.check, e.existing_node), e.reason
        ms.append((time.perf_counter() - t0) * 1e3)
        emb = np.asarray(node.embedding, np.float32)
        oracle.last_scores, oracle.probe_tie = np.zeros(0), False
        rej = WriteGate.check_all(node, emb, oracle, cx.storage, wg,
                                  cx.schema_validator)
        want = None if rej is None else (rej.check, rej.existing_node)
        near = (gate_near_tie(oracle.last_scores, wg, node.kind)
                or oracle.probe_tie)
        counts["near_ties"] += near
        if got != want:
            check(near, f"gate decision {got} differs from the oracle's "
                  f"{want} for {node.title!r}")
            counts["differ_at_near_tie"] += 1
        if exact is not None:
            ex = WriteGate.check_all(node, emb, exact, cx.storage, wg,
                                     cx.schema_validator)
            counts["differ_from_exact"] += (
                None if ex is None else (ex.check, ex.existing_node)) != got
        if node.id in planted and got is not None and got[0] == "conflict":
            counts["planted_rejected"] += 1
        elif node.id in planted:
            # on the IVF index, the original may lie in no list that its
            # own vector probes (the capped packing's stranded rows):
            # the probed lists' oracle then lets it through as well
            check(isinstance(oracle, ProbedGateIndex) and got == want,
                  f"planted duplicate {node.id} got {got}")
            counts["planted_unprobed"] += 1
        if got is None:
            counts["stored"] += 1
            for o in (oracle, exact):
                if isinstance(o, ExactGateIndex):
                    o.add(node.id, emb)
        elif got[0] == "conflict":
            counts["conflict_contradiction" if "contradiction" in reason
                   else "conflict_duplicate"] += 1
        else:
            counts[got[0]] += 1
    check(counts["planted_rejected"] + counts["planted_unprobed"]
          == len(planted) and counts["planted_rejected"] > 0,
          "the planted duplicates did not go through the gate")
    return counts, ms


def percentiles(ms):
    return {"p50": float(np.percentile(ms, 50)),
            "p99": float(np.percentile(ms, 99))}


def phase_gate_ivf(cx, card):
    """Phase 12, gated writes on phase 4's IVF Cortex at the reference's
    defaults (hash-384, nprobe auto, the kNN graph at degree 32; the
    gate searches with refine=False, so probed_scores and the exact
    re-rank): SVC_GATE_IVF gated stores held to the probed lists' exact
    top 5 (ProbedGateIndex), and counted against the exact top 5 over
    every row."""
    from cortex_tpu_torch.storage import NodeFilter
    stored = cx.storage.list_nodes(NodeFilter())
    check(cx.index.index_info()["kind"] == "ivf", "phase 4's Cortex is "
          "not on the IVF index")
    fresh = seeded_nodes(SVC_GATE_IVF, seed=9)
    cands, planted = gate_candidates(stored, fresh, SVC_GATE_IVF, seed=12)
    exact = ExactGateIndex([n.id for n in stored],
                           [n.embedding for n in stored])
    counts, ms = gate_pass(cx, cands, planted,
                           ProbedGateIndex(cx.index._corpus), exact)
    say("12-gate-ivf", writes=len(cands), planted=len(planted),
        gated_store_ms=percentiles(ms), nlist=cx.index.index_info()[
            "nlist"], nprobe=cx.index.index_info()["nprobe"], card=card,
        **counts)


def phase_gate_flat(dev, workdir, card):
    """Phase 12, gated writes on phase 11's SQLite Cortex (model
    "flax:<npz>" at BGE-small's width, the flat index over 20,200 nodes:
    each write embeds through E1 and E2, then K1 and K2 search it):
    SVC_UNGATED ungated stores, then SVC_GATE_FLAT gated ones held to an
    exact fp32 numpy top-5 over the stored embeddings (ExactGateIndex);
    the store times of both."""
    from cortex_tpu_torch import Cortex
    from cortex_tpu_torch.config import CortexConfig
    from cortex_tpu_torch.storage import NodeFilter
    cfg = CortexConfig()
    cfg.embedding.model = f"flax:{os.path.join(workdir, 'bge_small_random.npz')}"
    cfg.embedding.dimension = 384
    cx = Cortex.open(os.path.join(workdir, "encoder_flat.db"), cfg,
                     device=dev)
    check(cx.index.index_info()["resolved_path"] == "quant",
          "phase 11's Cortex does not search through K1 + K2")
    stored = cx.storage.list_nodes(NodeFilter())
    oracle = ExactGateIndex([n.id for n in stored],
                            [n.embedding for n in stored])
    words = encoder_words(ENC_SEED)[0]
    fresh = encoder_nodes(SVC_GATE_FLAT + SVC_UNGATED, ENC_SEED + 7, words)
    ungated = []
    for node in fresh[SVC_GATE_FLAT:]:
        t0 = time.perf_counter()
        cx.store(node)
        ungated.append((time.perf_counter() - t0) * 1e3)
        oracle.add(node.id, np.asarray(node.embedding, np.float32))
    cands, planted = gate_candidates(stored, fresh[:SVC_GATE_FLAT],
                                     SVC_GATE_FLAT, seed=13)
    counts, ms = gate_pass(cx, cands, planted, oracle)
    cx.close()
    say("12-gate-flat", writes=len(cands), planted=len(planted),
        ungated_store_ms=percentiles(ungated),
        gated_store_ms=percentiles(ms), nodes=len(stored), card=card,
        **counts)


def svc_config():
    """CortexConfig() with a [retention] section: a default TTL of 90
    days, observations 30 days, events 60 days with min_score 0.3, grace
    14 days."""
    from cortex_tpu_torch.config import CortexConfig
    from cortex_tpu_torch.policies import KindRetention, RetentionConfig
    cfg = CortexConfig()
    cfg.retention = RetentionConfig(
        default_ttl_days=90.0, grace_days=14.0,
        by_kind={"observation": KindRetention(ttl_days=30.0),
                 "event": KindRetention(ttl_days=60.0, min_score=0.3)})
    return cfg


def svc_words(rng, vocab, n):
    return " ".join(rng.choice(vocab, n))


def svc_briefing_world(cx, seed):
    """SVC_AGENTS agents, every third with an agent node: preferences,
    patterns and facts that apply to it, goals it depends on, recent
    events, and a contradiction between two of its facts."""
    from cortex_tpu_torch.types import Edge, EdgeProvenance, Node, Source
    rng = np.random.default_rng(seed)
    vocab = np.array([f"v{i}" for i in range(4000)])
    nodes, edges, agents = [], [], []
    for a in range(SVC_AGENTS):
        agent = f"svc{a}"
        agents.append(agent)
        me = None
        if a % 3 == 0:
            me = Node.new("agent", f"Agent {agent} assistant",
                          f"Agent {agent} handles {svc_words(rng, vocab, 8)}",
                          Source(agent=agent), 0.8)
            nodes.append(me)
        own = [Node.new(kind, f"{kind} of {agent} {svc_words(rng, vocab, 3)}",
                        f"{svc_words(rng, vocab, 14)} always",
                        Source(agent=agent), float(rng.uniform(0.35, 0.95)))
               for kind, k in (("preference", 3), ("pattern", 2),
                               ("fact", 2), ("goal", 2), ("event", 3))
               for _ in range(k)]
        nodes += own
        prov = EdgeProvenance.manual(agent)
        facts = [n for n in own if n.kind == "fact"]
        edges.append(Edge.new(facts[0].id, facts[1].id, "contradicts", 0.8,
                              prov))
        if me is not None:
            edges.append(Edge.new(me.id, facts[0].id, "related_to", 0.8,
                                  prov))
            for n in own:
                if n.kind in ("preference", "pattern", "fact"):
                    edges.append(Edge.new(n.id, me.id, "applies_to", 0.9,
                                          prov))
                elif n.kind == "goal":
                    edges.append(Edge.new(me.id, n.id, "depends_on", 0.9,
                                          prov))
    cx.store_batch(nodes)
    for e in edges:
        cx.create_edge(e)
    return agents, nodes


def svc_retention_world(cx, sources, seed, now):
    """SVC_RET_NODES nodes through store_batch with seeded ages (0-200
    days) and idle times (0-60 days, at most the age), across every TTL
    and the grace window, access counts 0-40, and informed_by edges from
    the live `sources` into a tenth of them; then SVC_TOMBSTONES more,
    deleted and backdated 30 days (purged) or 5 days (kept)."""
    from cortex_tpu_torch.types import Edge, EdgeProvenance, Node, Source
    rng = np.random.default_rng(seed)
    vocab = np.array([f"r{i}" for i in range(4000)])
    kinds = ("fact", "event", "observation", "goal", "decision")
    nodes = []
    for i in range(SVC_RET_NODES + SVC_TOMBSTONES):
        age = rng.uniform(0.0, 200.0)
        idle = min(rng.uniform(0.0, 60.0), age)
        n = Node.new(kinds[i % len(kinds)],
                     f"aged record {i} {svc_words(rng, vocab, 3)}",
                     svc_words(rng, vocab, 14), Source(agent=f"ret{i % 50}"),
                     float(rng.uniform(0.2, 0.9)))
        n.created_at = n.updated_at = now - age * 86400.0
        n.last_accessed_at = now - idle * 86400.0
        n.access_count = int(rng.integers(0, 40))
        nodes.append(n)
    cx.store_batch(nodes)
    targets = rng.choice(SVC_RET_NODES, SVC_RET_NODES // 10, replace=False)
    prov = EdgeProvenance.manual("retention")
    cx.bulk_import([], edges=[
        Edge.new(sources[j % len(sources)].id, nodes[t].id, "informed_by",
                 0.7, prov) for j, t in enumerate(targets)])
    for j, n in enumerate(nodes[SVC_RET_NODES:]):
        cx.delete_node(n.id)
        got = cx.storage.get_node(n.id)
        got.updated_at = now - (30.0 if j % 2 else 5.0) * 86400.0
        cx.storage.put_node(got)
    return nodes


def briefing_sections(b):
    return [(s.title, [n.id for n in s.nodes]) for s in b.sections]


def without_clock(text):
    return "\n".join(line for line in text.splitlines()
                     if "Generated" not in line)


def spy_hybrid(cx, seen, errors):
    """Record each hybrid search the briefing engine runs (its results)
    and each error: the engine swallows them (its active context then
    falls back to the recent list), so the phase fails on any."""
    inner = cx.hybrid.search

    def search(q):
        try:
            res = inner(q)
        except Exception as e:
            errors.append(f"{type(e).__name__}: {e}")
            raise
        seen.append(res)
        return res

    cx.hybrid.search = search


def hybrid_tied(want, got):
    """Whether two hybrid result lists differ only where combined scores
    tie within NEAR_TIE: the same combined score rank by rank, the same
    score for every id both lists hold, and an id in one list only where
    its score ties the last one (a tie across the limit may keep either
    id, as same_hits allows)."""
    if len(want) != len(got):
        return False
    ws = np.asarray([r.combined_score for r in want])
    if np.abs(ws - [r.combined_score for r in got]).max(
            initial=0.0) > NEAR_TIE:
        return False
    w = {r.node.id: r.combined_score for r in want}
    g = {r.node.id: r.combined_score for r in got}
    for nid in w.keys() | g.keys():
        if nid in w and nid in g:
            if abs(w[nid] - g[nid]) > NEAR_TIE:
                return False
        elif abs(w.get(nid, g.get(nid)) - ws[-1]) > NEAR_TIE:
            return False
    return True


def svc_briefings(cx, twin, agents):
    """briefing_full and both renderings for every agent on the card and
    on the CPU twin: the same sections with the same node ids (the
    active context may differ only where hybrid scores tie within
    NEAR_TIE, counted), the same text but the clock line; a second call
    hits the cache; a store invalidates it."""
    seen, errors = {"card": [], "cpu": []}, []
    spy_hybrid(cx, seen["card"], errors)
    spy_hybrid(twin, seen["cpu"], errors)
    ms, ties, sections = [], 0, 0
    for a in agents:
        t0 = time.perf_counter()
        b = cx.briefing_full(a)
        ms.append((time.perf_counter() - t0) * 1e3)
        w = twin.briefing_full(a)
        got, want = briefing_sections(b), briefing_sections(w)
        sections += len(got)
        if got != want:
            check([t for t, _ in got] == [t for t, _ in want]
                  and all(g == x for g, x in zip(got, want)
                          if g[0] != "Active Context")
                  and hybrid_tied(seen["cpu"][-1], seen["card"][-1]),
                  f"{a}: the card's briefing differs from the CPU's")
            ties += 1
        else:
            for compact in (False, True):
                check(without_clock(cx.briefing(a, compact=compact))
                      == without_clock(twin.briefing(a, compact=compact)),
                      f"{a}: the renderings differ")
        check(cx.briefing_full(a).cached, f"{a}: no cache hit")
    check(not errors, f"hybrid search failed in a briefing: {errors[:3]}")
    check(all(seen.values()), "no briefing ran a hybrid search")
    from cortex_tpu_torch.types import Node, Source
    n = Node.new("event", f"fresh event for {agents[0]}",
                 "A fresh event that the next briefing must show",
                 Source(agent=agents[0]), 0.9)
    twin.store(Node.from_dict(n.to_dict()))
    cx.store(n)
    b, w = cx.briefing_full(agents[0]), twin.briefing_full(agents[0])
    check(not b.cached and not w.cached
          and n.id in {x.id for s in b.sections for x in s.nodes},
          "a store did not invalidate the briefing cache")
    return {"agents": len(agents), "sections": sections,
            "active_context_ties": ties,
            "briefing_ms": percentiles(ms),
            "with_agent_node": sum(
                cx.briefing_engine.find_agent_node(a) is not None
                for a in agents)}


def retention_passes(rc):
    """The engine's sweep passes as (kinds, ttl_days, min_score): one per
    configured kind with a TTL, then the default pass over every other
    kind (kinds None)."""
    out = [([k], kr.ttl_days, kr.min_score) for k, kr in rc.by_kind.items()
           if kr.ttl_days != 0]
    if rc.default_ttl_days > 0:
        out.append((None, rc.default_ttl_days, None))
    return out


def r1_masks(cx, live, now, dev):
    """R1 over the live nodes' packed arrays, one launch a pass as the
    engine sweeps them (scalar parameters), and one launch over every
    node with the parameters one a node; both give the same ids. score
    is the engine's decayed score (apply_score_decay at recency 1.0);
    has_inbound, a live inbound edge from an undeleted source. Returns
    (eligible ids, each node's pass (ttl, min_score), per-pass device
    ms)."""
    import torch
    from cortex_tpu_torch.ops import decay
    from cortex_tpu_torch.vector.scoring import apply_score_decay_batch
    rc = cx.config.retention
    ids = {n.id for n in live}
    inbound = {e.to_id for e in cx.storage.all_edges() if e.from_id in ids}

    def dev_f32(vals):
        return torch.from_numpy(np.asarray(vals, np.float64).astype(
            np.float32)).to(dev)

    created = dev_f32([n.created_at for n in live])
    last = dev_f32([n.last_accessed_at for n in live])
    score = torch.from_numpy(apply_score_decay_batch(
        cx.config.score_decay, np.ones(len(live)), live, now=now,
        recency_bias=1.0)).to(dev)
    has_in = torch.tensor([n.id in inbound for n in live], device=dev)
    configured = set(rc.by_kind)
    eligible, param_of, dev_ms = set(), {}, 0.0
    per_ttl = np.zeros(len(live), np.float32)
    per_min = np.full(len(live), -1.0, np.float32)
    for kinds, ttl, min_score in retention_passes(rc):
        sel = np.array([i for i, n in enumerate(live) if (
            n.kind in kinds if kinds else n.kind not in configured)])
        if not len(sel):
            continue
        idx = torch.from_numpy(sel).to(dev)
        args = [t[idx] for t in (created, last, score, has_in)]
        params = [torch.tensor(v, dtype=torch.float32, device=dev) for v in (
            now, ttl, rc.grace_days,
            -1.0 if min_score is None else min_score)] + [
            torch.tensor(rc.protect_with_inbound_edges, device=dev)]
        mask = decay.retention_eligibility(*args, *params).cpu().numpy()
        with uncounted():
            dev_ms += time_ms(
                lambda: decay.retention_eligibility(*args, *params), 20)
        eligible.update(live[i].id for i in sel[mask])
        per_ttl[sel] = ttl
        per_min[sel] = -1.0 if min_score is None else min_score
        for i in sel:
            param_of[live[i].id] = (ttl, min_score)
    full = decay.retention_eligibility(
        created, last, score, has_in, now, torch.from_numpy(per_ttl).to(dev),
        rc.grace_days, torch.from_numpy(per_min).to(dev),
        rc.protect_with_inbound_edges).cpu().numpy()
    check({live[i].id for i in np.nonzero(full)[0]} == eligible,
          "R1 with per-node parameters differs from its passes")
    scores = dict(zip((n.id for n in live), score.cpu().numpy()))
    return eligible, param_of, scores, dev_ms


def in_retention_band(node, now, ttl, grace, min_score, score):
    """Whether the node lies within RET_BAND_S of the TTL or grace
    boundary (float32 epoch seconds are 128 s apart near `now`), or its
    float32 score within an ulp of min_score."""
    age = now - node.created_at - ttl * 86400.0
    idle = now - node.last_accessed_at - grace * 86400.0
    if min(abs(age), abs(idle)) <= RET_BAND_S:
        return True
    return (min_score is not None and abs(float(score) - min_score)
            <= float(np.spacing(np.float32(min_score))))


def deleted_ids(cx):
    from cortex_tpu_torch.storage import NodeFilter
    return {n.id for n in cx.storage.list_nodes(NodeFilter(
        deleted_only=True))}


def svc_retention(cx, twin, dev):
    """run_retention on the card and on the CPU twin: equal swept and
    purged ids; no swept node in the index or in a search for its own
    text; R1's mask over the same nodes equal to the engine's decisions
    but within the float32 band (counted)."""
    from cortex_tpu_torch.storage import NodeFilter
    from cortex_tpu_torch.vector.embedding import embedding_input
    live = cx.storage.list_nodes(NodeFilter())
    stones = deleted_ids(cx)
    now = time.time()
    eligible, param_of, scores, r1_ms = r1_masks(cx, live, now, dev)
    t0 = time.perf_counter()
    got = cx.run_retention()
    sweep_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = twin.run_retention()
    twin_s = time.perf_counter() - t0
    check(got == want, f"run_retention {got} on the card, {want} on the CPU")
    after = deleted_ids(cx)
    check(after == deleted_ids(twin), "the swept ids differ from the CPU's")
    swept = after - stones
    purged = {i for i in stones if cx.storage.get_node(i) is None}
    check(purged == {i for i in stones if twin.storage.get_node(i) is None},
          "the purged ids differ from the CPU's")
    check(len(swept) == got[0] and len(purged) == got[1] > 0,
          f"swept {len(swept)} / purged {len(purged)} against {got}")
    check(not any(i in cx.index for i in swept), "a swept node is indexed")
    by_id = {n.id: n for n in live}
    for nid in sorted(swept)[:200]:
        hits = cx.search(embedding_input(by_id[nid]), 10,
                         record_access=False)
        check(nid not in {n.id for _, n in hits},
              "a swept node came back from search")
    band = 0
    grace = cx.config.retention.grace_days
    for nid in eligible ^ swept:
        ttl, min_score = param_of.get(nid, (0.0, None))
        check(nid in by_id and in_retention_band(
            by_id[nid], now, ttl, grace, min_score, scores[nid]),
            f"R1 and the engine disagree on {nid} outside the band")
        band += 1
    return {"live_before": len(live), "swept": got[0], "purged": got[1],
            "r1_eligible": len(eligible), "r1_engine_differ_in_band": band,
            "sweep_s": sweep_s, "cpu_twin_sweep_s": twin_s,
            "r1_device_ms": r1_ms}


SVC_QUERIES = ["kind:fact", "kind:event,goal AND importance>0.5",
               "agent:svc3", "agent:ret7 AND kind:observation",
               "created_after:7d AND kind:pattern",
               "(kind:decision OR kind:goal) AND importance<=0.4",
               "NOT deleted:true AND limit:50"]


def svc_prompts(cx):
    """Prompt create, version, branch, select and rollback through
    cx.prompts and cx.rollback_monitor."""
    import random
    from cortex_tpu_torch.prompt import (ContextSignals, PromptContent,
                                         epsilon_greedy_pick, score_variant)
    from cortex_tpu_torch.types import Node, Source
    res = cx.prompts

    def content(v, weights=None):
        return PromptContent(slug="svc-helper", prompt_type="persona",
                             sections={"v": v},
                             context_weights=weights or {})

    v1 = res.create_prompt(content(1))
    v2 = res.create_version("svc-helper", "main", content(
        2, {"user_pleased": 1.0}))
    res.create_branch("svc-helper", "main", "terse", base_version=1)
    heads = {b: res.find_head("svc-helper", b) for b in ("main", "terse")}
    check(heads["main"].id == v2, "the version did not become the head")
    signals = ContextSignals(sentiment=0.9)
    scored = {b: score_variant(0.5, h.metadata.get("context_weights"),
                               signals) for b, h in heads.items()}
    pick = epsilon_greedy_pick(scored, epsilon=0.0, rng=random.Random(0))
    check(pick == "main", f"selection picked {pick} from {scored}")
    mon = cx.rollback_monitor
    mon.record_deployment("svc-helper", "main", 2, v2, "svc0",
                          [(0.1, 0.8), (0.12, 0.75), (0.11, 0.82)])
    result = None
    for i in range(5):
        obs = Node.new("observation", f"Interaction observation {i}",
                       "Observed interaction outcome details here",
                       Source(agent="svc0"), 0.5)
        cx.store(obs)
        result = result or mon.process_observation(obs.id, v2, 0.12, 0.75,
                                                   0.2)
    check(result is not None and result.to_node_id == v1,
          "the rollback did not return to version 1")
    status = mon.get_status("svc-helper", "main")
    check(status.rollback_count == 1, f"rollback status {status}")
    return {"versions": len(res.list_versions("svc-helper", "main")),
            "picked": pick, "rollback_trigger": result.trigger.kind}


def svc_reindex(cx, live):
    """reindex() with SVC_SEARCHES searches before and after it: the
    same hits (same_hits); every holder of the index re-pointed and the
    old index released. Every live node is indexed before (nodes put
    into storage directly, as the prompt subsystem's are, are indexed
    only by a reindex), so the hits cannot change."""
    from cortex_tpu_torch.errors import IndexError_
    from cortex_tpu_torch.vector.embedding import embedding_input
    check(all(n.id in cx.index for n in live),
          "a live node is missing from the index before reindex")
    texts = [embedding_input(n) for n in live[::max(1, len(live)
                                                    // SVC_SEARCHES)]]
    texts = texts[:SVC_SEARCHES]

    def hits():
        return [cx.search(t, K, decay=False, record_access=False)
                for t in texts]

    before, old = hits(), cx.index
    t0 = time.perf_counter()
    n = cx.reindex()
    reindex_s = time.perf_counter() - t0
    for b, a in zip(before, hits()):
        same_hits(b, a)
    check(cx.hybrid.index is cx.briefing_engine.index is cx.linker.index
          is cx.index is not old, "reindex left a holder on the old index")
    try:
        old.search(np.ones(cx.embedder.dimension, np.float32), 1)
        released = False
    except IndexError_:
        released = True
    check(released, "the old index still searches after reindex")
    return {"reindexed": n, "reindex_s": reindex_s,
            "searches_equal": len(texts)}


def phase_services_store(dev, workdir, card):
    """Phase 12 on phase 8's SQLite store (CortexConfig() with svc_config's
    [retention]): the briefing world and the retention world added,
    closed and byte-copied; then the card's Cortex and a CPU twin
    (device "cpu") on the copy: briefings, retention (and R1), queries
    and stats held equal; prompts and reindex on the card."""
    from cortex_tpu_torch import Cortex
    from cortex_tpu_torch.storage import NodeFilter
    t_phase = time.monotonic()
    path = os.path.join(workdir, "cortex_flat.db")
    cfg = svc_config()
    cx = Cortex.open(path, cfg, device=dev)
    now = time.time()
    agents, world = svc_briefing_world(cx, seed=31)
    svc_retention_world(cx, world, seed=32, now=now)
    cx.close()
    twin_path = os.path.join(workdir, "cortex_twin.db")
    for f in os.listdir(workdir):             # the store and its snapshot
        if f.startswith("cortex_flat.db"):
            shutil.copyfile(os.path.join(workdir, f),
                            twin_path + f[len("cortex_flat.db"):])
    cx = Cortex.open(path, cfg, device=dev)
    twin = Cortex.open(twin_path, svc_config(), device="cpu")
    agents = agents + [f"agent{i}" for i in range(4)]     # phase 6's
    out = {"briefings": svc_briefings(cx, twin, agents)}
    out["retention"] = svc_retention(cx, twin, dev)
    for q in SVC_QUERIES:
        check([n.id for n in cx.query(q)] == [n.id for n in twin.query(q)],
              f"query {q!r} differs from the CPU's")
    got, want = cx.stats(), twin.stats()
    for f in ("node_count", "edge_count", "deleted_node_count",
              "nodes_by_kind", "edges_by_relation"):
        check(getattr(got, f) == getattr(want, f), f"stats {f} differ")
    out["queries"] = len(SVC_QUERIES)
    out["stats"] = {"nodes": got.node_count, "edges": got.edge_count}
    twin.close()
    out["reindex"] = svc_reindex(cx, cx.storage.list_nodes(NodeFilter()))
    out["prompts"] = svc_prompts(cx)
    cx.close()
    say("12-services", phase_s=time.monotonic() - t_phase, card=card, **out)



# ------------------------------------------------------------ main


# ------------------------------------------------------------ phase 13


def same_index_hits(want, got, what):
    """Index hits (id, score) rank by rank: scores within NEAR_TIE, ids
    equal at every rank whose score lies further than NEAR_TIE from the
    others' (a loaded index holds its rows on other rows, so exact ties
    fall apart in another order), and the same ids above the last
    score."""
    check(len(got) == len(want), f"{what}: {len(got)} hits, want "
          f"{len(want)}")
    ws = np.asarray([s for _, s in want], np.float64)
    np.testing.assert_allclose([s for _, s in got], ws, atol=NEAR_TIE,
                               err_msg=what)
    for j, ((wi, _), (gi, _)) in enumerate(zip(want, got)):
        gap = np.abs(ws - ws[j])
        gap[j] = np.inf
        if gap.min() > NEAR_TIE:
            check(gi == wi, f"{what}: rank {j} holds {gi}, want {wi}")
    if len(ws):
        floor = ws[-1] + NEAR_TIE
        check({i for i, s in want if s > floor}
              == {i for i, s in got if s > floor}, f"{what}: other ids")


def fresh_like(index, dev):
    """An empty index with `index`'s configuration on `dev`."""
    from cortex_tpu_torch.vector.index import TorchFlatIndex
    from cortex_tpu_torch.vector.ivf import TorchIvfIndex
    co = index._corpus
    if isinstance(index, TorchIvfIndex):
        return TorchIvfIndex(index.dim, nlist=co._nlist_cfg,
                             nprobe=co._nprobe_cfg, spill=co._spill,
                             graph_degree=co._graph_degree,
                             target_recall=co._target_recall, device=dev)
    return TorchFlatIndex(index.dim, search_path=co._search_path,
                          storage_dtype=index._storage_dtype_str(),
                          device=dev)


def snapshot_mutations(index, gen, dev, n=SNAP_MUTATED):
    """n rows mutated through the index API: n // 2 updated (a new
    vector for a live id), 2 n / 5 inserted, the rest removed."""
    co = index._corpus
    live = [i for i in co._id_of if i is not None]
    rng = np.random.default_rng(13)
    picks = rng.choice(len(live), size=n // 2 + n // 10, replace=False)
    upd = [live[p] for p in picks[:n // 2]]
    gone = [live[p] for p in picks[n // 2:]]
    vecs, _ = clustered_rows(gen, dev, n // 2 + 2 * n // 5, index.dim,
                             groups=100, spread=0.5)
    vecs = vecs.cpu().numpy()
    index.insert_batch(upd, vecs[:n // 2], kinds=["k8"] * len(upd))
    fresh = [f"snap{i}" for i in range(2 * n // 5)]
    index.insert_batch(fresh, vecs[n // 2:], kinds=["k8"] * len(fresh))
    for i in gone:
        check(index.remove(i), f"remove({i}) failed")
    return len(upd) + len(fresh) + len(gone)


def same_contents(a, b, what):
    """Two indexes hold the same ids, kinds and agents, and rows within
    SNAP_ROW_ATOL (a load normalizes the saved unit rows once more, as
    the reference's does). Returns the rows' largest difference."""
    ca, cb = a._corpus, b._corpus
    check(ca._row_of.keys() == cb._row_of.keys(), f"{what}: ids differ")
    ra = np.fromiter(ca._row_of.values(), np.int64)
    rb = np.fromiter((cb._row_of[i] for i in ca._row_of), np.int64)
    err = float(np.abs(ca._emb_h[ra] - cb._emb_h[rb]).max())
    check(err <= SNAP_ROW_ATOL, f"{what}: rows differ by {err}")
    for attr, plane in (("kinds", "_kind_h"), ("agents", "_agent_h")):
        na = np.asarray(getattr(ca, attr)._name, object)[
            getattr(ca, plane)[ra]]
        nb = np.asarray(getattr(cb, attr)._name, object)[
            getattr(cb, plane)[rb]]
        check(np.array_equal(na, nb), f"{what}: {attr} differ")
    return err


def full_probe(index):
    """Searches of an IVF index at nprobe = nlist (no-op for flat)."""
    co = index._corpus
    if not hasattr(co, "_ivf_dev"):
        return contextlib.nullcontext()

    @contextlib.contextmanager
    def probe_all():
        old = co._nprobe_cfg
        co._nprobe_cfg = 1 << 20
        try:
            yield
        finally:
            co._nprobe_cfg = old
    return probe_all()


def exact_path(index):
    """Searches of a flat index on the exact product (no-op for IVF)."""
    co = index._corpus
    if hasattr(co, "_ivf_dev"):
        return contextlib.nullcontext()

    @contextlib.contextmanager
    def exact():
        old = co._search_path
        co._search_path = "exact"
        try:
            yield
        finally:
            co._search_path = old
    return exact()


def phase_snapshot(name, index, q_np, gen, dev, card):
    """Phase 13's index round trip on `index` (phase 3's IVF index, graph
    built, or phase 5's flat one): snapshot_state + write_snapshot (timed,
    the file's bytes); SNAP_MUTATED rows mutated and written as a delta
    link (timed); then the boot as Cortex makes it, load(base) +
    apply_delta(link) into a fresh index plus its first search (timed;
    the IVF boot repacks from the file's clustering: no k-means, tuning
    pass or N1 launch); the same contents as the in-memory index
    (same_contents) and the top-10 of phase 3's queries equal to its
    (NEAR_TIE) at the serving path and at nprobe = nlist / the exact
    product. The files lie in a temporary directory, each deleted when
    done."""
    import torch
    t_phase = time.monotonic()
    co = index._corpus
    is_ivf = hasattr(co, "_ivf_dev")
    with tempfile.TemporaryDirectory() as tmp:
        out = {"rows": len(index),
               "disk_free_gb": shutil.disk_usage(tmp).free / 1e9}
        base = os.path.join(tmp, "base.npz")
        t0 = time.monotonic()
        st = index.snapshot_state()
        index.begin_snapshot_base()
        out["capture_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        index.write_snapshot(base, st)
        out["write_s"] = time.monotonic() - t0
        out["file_bytes"] = os.path.getsize(base)
        del st
        out["mutated"] = snapshot_mutations(index, gen, dev)
        link = os.path.join(tmp, "link")
        t0 = time.monotonic()
        index.write_delta(link, index.delta_state(),
                          extra_meta={"base_seq": 0, "prev_seq": 0,
                                      "index_seq": 1})
        out["delta_write_s"] = time.monotonic() - t0
        out["delta_bytes"] = os.path.getsize(link + ".npz")
        want = index.search_batch(q_np, K)
        with full_probe(index), exact_path(index):
            want_exact = index.search_batch(q_np, K)
        knn0 = _wrappers()["block_knn"].launches
        torch.cuda.synchronize()
        t0 = time.monotonic()
        boot = fresh_like(index, dev)
        boot.load(base)
        out["load_s"] = time.monotonic() - t0
        meta = boot.apply_delta(link + ".npz")
        out["load_and_link_s"] = time.monotonic() - t0
        got = boot.search_batch(q_np, K)
        torch.cuda.synchronize()
        out["boot_and_first_search_s"] = time.monotonic() - t0
        os.remove(base)
        check(_wrappers()["block_knn"].launches == knn0,
              f"{name}: the snapshot boot launched N1")
        check(len(meta["ids"]) + len(meta["removed"]) == out["mutated"],
              f"{name}: the link holds {len(meta['ids'])} rows and "
              f"{len(meta['removed'])} removals")
        out["rows_max_abs_diff"] = same_contents(index, boot, name)
        bco = boot._corpus
        if is_ivf:
            check(bco._nbrs_h is not None, f"{name}: no graph after boot")
            check(np.array_equal(bco._centroids_h, co._centroids_h),
                  f"{name}: centroids differ")
            # every row the link left alone in its saved home list, but
            # where the repack's capped lists overflow (the loader then
            # takes any list with room, as the reference's does)
            moved = set(meta["ids"]) | set(meta["removed"])
            kept = [i for i in co._row_of if i not in moved]
            rows = np.fromiter((co._row_of[i] for i in kept), np.int64)
            brows = np.fromiter((bco._row_of[i] for i in kept), np.int64)
            out["home_list_equal"] = [int((bco._cluster_of[brows]
                                           == co._cluster_of[rows]).sum()),
                                      len(kept)]
            out["spill_copies"] = [int((bco._cluster_of2 >= 0).sum()),
                                   int((co._cluster_of2 >= 0).sum())]
            check(out["home_list_equal"][0] >= SNAP_HOME_SHARE * len(kept),
                  f"{name}: {out['home_list_equal']} rows in their saved "
                  f"list")
            out["lists"] = int(bco._ivf_dev[0].shape[0])
            # the graph by ids over those rows: a mutated row's
            # out-edges are dropped in both, and an edge into a freed row
            # names whichever id reuses it
            stable = kept[:SNAP_GRAPH_ROWS]

            def edges(c, nid):
                return [c._id_of[x] for x in c._nbrs_h[c._row_of[nid]]
                        if x >= 0 and c._id_of[x] is not None
                        and c._id_of[x] not in moved]
            out["graph_rows_equal"] = sum(edges(bco, i) == edges(co, i)
                                          for i in stable)
            check(out["graph_rows_equal"] == len(stable),
                  f"{name}: the graph differs")
        for b, (w, g) in enumerate(zip(want, got)):
            same_index_hits(w, g, f"{name} boot, query {b}")
        with full_probe(boot), exact_path(boot):
            for b, (w, g) in enumerate(zip(want_exact, boot.search_batch(
                    q_np, K))):
                same_index_hits(w, g, f"{name} boot exact, query {b}")
        boot.close()
        del boot
    torch.cuda.empty_cache()
    say(f"13-snapshot-{name}-1M", card=card,
        phase_s=time.monotonic() - t_phase, **out)


class ServedServer:
    """The port's Server (server/serve.py) on an event loop of its own
    thread, so that this thread drives it as a client would: boot (timed,
    its warmup timed apart), then stop."""

    def __init__(self, cfg, dev):
        import asyncio
        import threading
        from cortex_tpu_torch.server.serve import Server
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True, name="served-loop")
        self.thread.start()
        self.srv = Server(cfg, device=dev)
        self.warmup_s = None
        warm = self.srv._warmup

        def timed_warmup():
            t0 = time.monotonic()
            warm()
            self.warmup_s = time.monotonic() - t0
        self.srv._warmup = timed_warmup
        t0 = time.monotonic()
        asyncio.run_coroutine_threadsafe(self.srv.start(),
                                         self.loop).result(timeout=900)
        self.boot_s = time.monotonic() - t0
        self.base = f"http://{cfg.server.http_addr}"

    def stop(self):
        import asyncio
        try:
            asyncio.run_coroutine_threadsafe(self.srv.stop(),
                                             self.loop).result(timeout=300)
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(timeout=60)
            self.loop.close()


def http(method, url, body=None, headers=None):
    """One HTTP request: (status, JSON body)."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        url, method=method,
        data=None if body is None else json.dumps(body).encode())
    req.add_header("content-type", "application/json")
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            raw = resp.read().decode()
            status = resp.status
    except urllib.error.HTTPError as e:
        raw, status = e.read().decode(), e.code
    try:
        return status, json.loads(raw)
    except json.JSONDecodeError:
        return status, raw


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def serve_data_dir(workdir):
    """<workdir>/serve holding phase 11's encoder_flat.db and its index
    snapshot under the name the server opens (cortex.db)."""
    data_dir = os.path.join(workdir, "serve")
    os.makedirs(data_dir)
    for f in os.listdir(workdir):
        if f.startswith("encoder_flat.db"):
            shutil.copyfile(os.path.join(workdir, f), os.path.join(
                data_dir, "cortex.db" + f[len("encoder_flat.db"):]))
    check(os.path.exists(os.path.join(data_dir, "cortex.db.index.npz")),
          "phase 12's close wrote no index snapshot")
    return data_dir


def snapshot_files(data_dir):
    """{file name: bytes} of the index snapshot sidecar and its links."""
    return {f: os.path.getsize(os.path.join(data_dir, f))
            for f in os.listdir(data_dir)
            if f.startswith("cortex.db.index.npz")}


def cli_serve(data_dir, npz, words, acked, dev):
    """`python -m cortex_tpu_torch --device <dev> --config
    <data_dir>/cortex.toml serve` as a user starts it: boot until GET
    /health answers (timed), one GET /search and one acknowledged write
    (the gate's override), then SIGTERM, and the process exits 0. It
    booted from the snapshot: its close appended a delta link and left
    the base as it was (a rebuilt index rewrites the base)."""
    import signal
    import subprocess
    http_addr = f"127.0.0.1:{free_port()}"
    toml = os.path.join(data_dir, "cortex.toml")
    with open(toml, "w") as f:
        f.write(f"""[server]
data_dir = "."
http_addr = "{http_addr}"
grpc_addr = "127.0.0.1:{free_port()}"
warmup = true

[embedding]
model = "flax:{npz}"
dimension = 384

[auto_linker]
interval_secs = 3600
""")
    base = f"http://{http_addr}"
    before = snapshot_files(data_dir)
    log_path = os.path.join(data_dir, "cli_serve.log")
    out = {}
    with open(log_path, "w") as log:
        t0 = time.monotonic()
        proc = subprocess.Popen(
            [sys.executable, "-m", "cortex_tpu_torch", "--device",
             dev.type, "--config", toml, "serve"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=log, stderr=subprocess.STDOUT)
        try:
            while True:
                check(proc.poll() is None, "the CLI server exited at boot: "
                      + open(log_path).read()[-2000:])
                check(time.monotonic() - t0 < CLI_BOOT_S,
                      "the CLI server did not answer /health")
                try:
                    if http("GET", base + "/health")[0] == 200:
                        break
                except OSError:
                    pass
                time.sleep(0.2)
            out["boot_to_health_s"] = time.monotonic() - t0
            q = encoder_queries(encoder_nodes(4, ENC_SEED + 25, words),
                                words, 1, ENC_SEED + 26)[0]
            status, body = http("GET", base + "/search?" + urlencode(
                {"q": q, "limit": K}))
            check(status == 200 and len(body["data"]) == K,
                  f"the CLI server's search: {status}")
            n = encoder_nodes(1, ENC_SEED + 27, words)[0]
            status, body = http(
                "POST", base + "/nodes?gate=skip",
                {"kind": n.kind, "title": n.title, "body": n.body},
                {"x-gate-override": "true"})
            check(status == 201, f"the CLI server's write: {status}")
            acked.append((body["data"]["id"],
                          served_text(n.kind, n.title, n.body)))
        finally:
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
    check(rc == 0, f"the CLI server exited {rc}: "
          + open(log_path).read()[-2000:])
    after = snapshot_files(data_dir)
    links = sorted(set(after) - set(before))
    check(after["cortex.db.index.npz"] == before["cortex.db.index.npz"]
          and len(links) == 1 and ".delta" in links[0],
          f"the CLI server did not boot from the snapshot: {before} -> "
          f"{after}")
    out["close_appended"] = links[0]
    return out


def serve_config(data_dir, npz, *, snapshot_boot=True, warmup=True):
    from cortex_tpu_torch.config import CortexConfig
    cfg = CortexConfig()
    cfg.embedding.model = f"flax:{npz}"
    cfg.embedding.dimension = 384
    cfg.embedding.snapshot_boot = snapshot_boot
    cfg.server.data_dir = data_dir
    cfg.server.http_addr = f"127.0.0.1:{free_port()}"
    cfg.server.grpc_addr = f"127.0.0.1:{free_port()}"
    cfg.server.warmup = warmup
    cfg.auto_linker.interval_secs = 3600.0    # no cycle while measuring
    return cfg


def served_text(kind, title, body):
    from cortex_tpu_torch.types import Node, Source
    from cortex_tpu_torch.vector.embedding import embedding_input
    return embedding_input(Node.new(kind, title, body, Source(agent="x")))


def same_served(want, got, what):
    """Served hits (id, score) against the in-process ones: scores within
    SCORE_ATOL rank by rank, ids equal at every rank whose score lies
    further than SCORE_ATOL from the others'."""
    check(len(got) == len(want), f"{what}: {len(got)} hits, in process "
          f"{len(want)}")
    ws = np.asarray([s for _, s in want], np.float64)
    np.testing.assert_allclose([s for _, s in got], ws, atol=SCORE_ATOL,
                               err_msg=what)
    for j, ((wi, _), (gi, _)) in enumerate(zip(want, got)):
        gap = np.abs(ws - ws[j])
        gap[j] = np.inf
        if gap.min() > SCORE_ATOL:
            check(gi == wi, f"{what}: rank {j} holds {gi}, in process {wi}")


def in_process(cx, q, limit=K):
    return [(n.id, s) for s, n in cx.search(q, limit, decay=False,
                                            record_access=False)]


def served_search(srv, cx, q, limit=K):
    """GET /search (decay off) held to the in-process Cortex.search on
    the server's own store (same_served); returns the served hits."""
    status, body = http("GET", f"{srv.base}/search?" + urlencode(
        {"q": q, "limit": limit, "decay": "false"}))
    check(status == 200, f"GET /search: {status} {body}")
    got = [(h["node"]["id"], h["score"]) for h in body["data"]]
    same_served(in_process(cx, q, limit), got, "HTTP search")
    return got


CONCURRENT_CLIENT = """
import json, sys, time, urllib.parse, urllib.request
from concurrent.futures import ThreadPoolExecutor
base, path, rounds = sys.argv[1], sys.argv[2], int(sys.argv[3])
queries = json.load(open(path))

def get(q):
    url = base + "/search?" + urllib.parse.urlencode({"q": q, "limit": 10})
    with urllib.request.urlopen(url, timeout=120) as resp:
        resp.read()
        return resp.status

with ThreadPoolExecutor(len(queries)) as pool:
    list(pool.map(get, queries))                  # connections warmed
    t0 = time.perf_counter()
    statuses = list(pool.map(get, queries * rounds))
    wall = time.perf_counter() - t0
print(json.dumps({"statuses": sorted(set(statuses)),
                  "searches": len(statuses),
                  "qps": len(statuses) / wall}))
"""


def concurrent_clients(base, queries):
    """len(queries) concurrent clients in a process of their own (so the
    clients' threads do not hold this process's interpreter lock), each
    searching SERVE_CONCURRENT_ROUNDS times after one untimed round;
    returns their statuses, count and q/s."""
    import subprocess
    with tempfile.NamedTemporaryFile("w", suffix=".json",
                                     delete=False) as f:
        json.dump(queries, f)
    try:
        proc = subprocess.run(
            [sys.executable, "-c", CONCURRENT_CLIENT, base, f.name,
             str(SERVE_CONCURRENT_ROUNDS)],
            capture_output=True, text=True, timeout=600)
    finally:
        os.unlink(f.name)
    check(proc.returncode == 0, f"the client process failed: "
          f"{proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def drive_server(srv, words, dev):
    """HTTP (gated POST /nodes and GET /search, SERVE_REQUESTS of each,
    p50 / p99; SERVE_CONCURRENT concurrent searches through the search
    batcher, q/s; briefing, /stats, /metrics), gRPC (create and search)
    and MCP (LocalBackend's store and search tools). Returns the
    timings and the acknowledged writes (id, text)."""
    from cortex_tpu_torch.server import cortex_pb2 as pb
    from cortex_tpu_torch.server.grpc_service import GrpcClient
    from cortex_tpu_torch.server.mcp import LocalBackend, McpServer
    cx = srv.srv.cortex
    nodes = encoder_nodes(2 * SERVE_REQUESTS, ENC_SEED + 21, words)
    acked, out = [], {}
    ms, codes = [], {}
    for i, n in enumerate(nodes[:SERVE_REQUESTS]):
        body = {"kind": n.kind, "title": n.title, "body": n.body,
                "agent": n.source.agent}
        t0 = time.perf_counter()
        status, resp = http("POST", f"{srv.base}/nodes", body)
        ms.append((time.perf_counter() - t0) * 1e3)
        codes[status] = codes.get(status, 0) + 1
        check(status in (201, 422), f"POST /nodes: {status} {resp}")
        if status == 201:
            acked.append((resp["data"]["id"], served_text(
                n.kind, n.title, n.body)))
    out["gated_post_ms"] = percentiles(ms)
    out["gated_post_status"] = codes
    # ungated writes (the gate's override): acknowledged whatever the
    # random weights' crowding makes of the conflict check
    for n in nodes[SERVE_REQUESTS:SERVE_REQUESTS + SERVE_UNGATED]:
        status, resp = http(
            "POST", f"{srv.base}/nodes?gate=skip",
            {"kind": n.kind, "title": n.title, "body": n.body},
            {"x-gate-override": "true"})
        check(status == 201, f"POST /nodes?gate=skip: {status} {resp}")
        acked.append((resp["data"]["id"], served_text(n.kind, n.title,
                                                       n.body)))
    queries = encoder_queries(nodes, words, SERVE_REQUESTS, ENC_SEED + 22)
    ms = []
    for q in queries:
        t0 = time.perf_counter()
        status, _ = http("GET", f"{srv.base}/search?" + urlencode(
            {"q": q, "limit": K}))
        ms.append((time.perf_counter() - t0) * 1e3)
        check(status == 200, f"GET /search: {status}")
    out["search_ms"] = percentiles(ms)
    for q in queries[:SERVE_COMPARED]:
        served_search(srv, cx, q)
    out["searches_equal_in_process"] = SERVE_COMPARED
    batcher = srv.srv.state.search_batcher
    sizes, inner = [], batcher.index

    class CountingIndex:
        def search_batch(self, v, k, flt=None):
            sizes.append(len(v))
            return inner.search_batch(v, k, flt)
    batcher.index = CountingIndex()
    try:
        got = concurrent_clients(srv.base, queries[:SERVE_CONCURRENT])
    finally:
        batcher.index = inner
    check(got["statuses"] == [200], f"concurrent searches: {got}")
    out["concurrent"] = {"clients": SERVE_CONCURRENT,
                         "searches": got["searches"], "qps": got["qps"],
                         "device_batches": len(sizes),
                         "batch_max": max(sizes), "batch_mean": float(
                             np.mean(sizes))}
    for path in (f"/briefing/{nodes[0].source.agent}", "/stats", "/metrics"):
        ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            status, body = http("GET", srv.base + path)
            ms.append((time.perf_counter() - t0) * 1e3)
            check(status == 200, f"GET {path}: {status}")
        out[f"get_{path.split('/')[1]}_ms_p50"] = float(np.median(ms))
    grpc = GrpcClient(srv.srv.config.server.grpc_addr)
    try:
        made = nodes[SERVE_REQUESTS + SERVE_UNGATED]
        resp = grpc.CreateNode(pb.CreateNodeRequest(
            kind=made.kind, title=made.title, body=made.body,
            source_agent="grpc", skip_gate=True))
        acked.append((resp.node.id, served_text(made.kind, made.title,
                                                made.body)))
        q = queries[0]
        hits = grpc.SimilaritySearch(pb.SimilaritySearchRequest(
            query=q, limit=K, skip_decay=True))
        same_served(in_process(cx, q),
                    [(h.node.id, h.score) for h in hits.hits], "gRPC search")
        got = grpc.GetNode(pb.GetNodeRequest(id=resp.node.id))
        check(got.node.title == made.title, "gRPC GetNode")
        out["grpc"] = {"created": True, "hits": len(hits.hits)}
    finally:
        grpc.close()
    mcp = McpServer(LocalBackend(cx))
    made = nodes[SERVE_REQUESTS + SERVE_UNGATED + 1]
    res = mcp.handle({"jsonrpc": "2.0", "id": 1, "method": "tools/call",
                      "params": {"name": "cortex_store", "arguments": {
                          "kind": made.kind, "title": made.title,
                          "body": made.body}}})
    stored = json.loads(res["result"]["content"][0]["text"]) if not res[
        "result"]["isError"] else None
    if stored is not None:
        acked.append((stored["id"], served_text(made.kind, made.title,
                                                made.body)))
    res = mcp.handle({"jsonrpc": "2.0", "id": 2, "method": "tools/call",
                      "params": {"name": "cortex_search", "arguments": {
                          "query": queries[1], "limit": K}}})
    check(not res["result"]["isError"], f"MCP search failed: {res}")
    out["mcp"] = {"store_accepted_by_gate": stored is not None,
                  "search_hits": len(json.loads(
                      res["result"]["content"][0]["text"]))}
    out["acknowledged_writes"] = len(acked)
    return out, acked


def phase_serve(dev, workdir, card):
    """Phase 13-serve: the composed server (HTTP + SSE, gRPC, the
    background loops) booted by Server(config, device="cuda") on phase
    11's flat encoder store (model "flax:<npz>" at BGE-small's width),
    copied with its index snapshot to <data_dir>/cortex.db. Boot A from
    the snapshot that phase 12's close wrote, with warmup: every surface
    driven (drive_server), the first search warm; stop (the close writes
    a delta link). Boot B with snapshot_boot = false (a rebuild), with
    warmup. Boot C from the snapshot, warmup off: no rebuild, every
    acknowledged write returned by GET /nodes/:id and by a search of its
    own text, the first search cold (the kernel library is loaded in
    this process already)."""
    import torch
    from cortex_tpu_torch.vector.embedding import TorchEncoderEmbedder
    from cortex_tpu_torch.vector.index import TorchFlatIndex
    t_phase = time.monotonic()
    npz = os.path.join(workdir, "bge_small_random.npz")
    data_dir = serve_data_dir(workdir)
    words = encoder_words(ENC_SEED)[0]
    rebuilds = []
    orig_insert = TorchFlatIndex.insert_batch

    def counted(self, *a, **k):
        rebuilds.append(len(a[0]))
        return orig_insert(self, *a, **k)
    TorchFlatIndex.insert_batch = counted
    out = {"store_nodes": None}
    try:
        srv = ServedServer(serve_config(data_dir, npz), dev)
        try:
            cx = srv.srv.cortex
            check(isinstance(cx.embedder, TorchEncoderEmbedder)
                  and cx.embedder.model.device.type == dev.type,
                  f"the server embeds with {type(cx.embedder).__name__}")
            check(cx._chain_bs is not None and not rebuilds,
                  "boot A rebuilt the index instead of loading its snapshot")
            check(srv.warmup_s is not None, "boot A ran no warmup")
            out["store_nodes"] = len(cx.index)
            out["boot_snapshot"] = {"boot_s": srv.boot_s,
                                    "warmup_s": srv.warmup_s}
            q = encoder_queries(encoder_nodes(4, ENC_SEED + 23, words),
                                words, 1, ENC_SEED + 24)[0]
            t0 = time.perf_counter()
            status, _ = http("GET", f"{srv.base}/search?" + urlencode(
                {"q": q, "limit": K}))
            out["first_search_warm_ms"] = (time.perf_counter() - t0) * 1e3
            check(status == 200, "the first search failed")
            driven, acked = drive_server(srv, words, dev)
            out.update(driven)
        finally:
            srv.stop()
        out["cli_serve"] = cli_serve(data_dir, npz, words, acked, dev)
        rebuilds.clear()
        srv = ServedServer(serve_config(data_dir, npz, snapshot_boot=False),
                           dev)
        try:
            check(sum(rebuilds) == out["store_nodes"] + len(acked),
                  f"boot B inserted {sum(rebuilds)} rows")
            out["boot_rebuild"] = {"boot_s": srv.boot_s,
                                   "warmup_s": srv.warmup_s}
        finally:
            srv.stop()
        rebuilds.clear()
        srv = ServedServer(serve_config(data_dir, npz, warmup=False), dev)
        try:
            cx = srv.srv.cortex
            check(cx._chain_bs is not None and not rebuilds,
                  "boot C rebuilt the index instead of loading its snapshot")
            out["boot_snapshot_no_warmup_s"] = srv.boot_s
            t0 = time.perf_counter()
            status, _ = http("GET", f"{srv.base}/search?" + urlencode(
                {"q": q, "limit": K}))
            out["first_search_cold_ms"] = (time.perf_counter() - t0) * 1e3
            check(status == 200, "the first search failed")
            for nid, text in acked:
                status, body = http("GET", f"{srv.base}/nodes/{nid}")
                check(status == 200 and body["data"]["id"] == nid,
                      f"acknowledged write {nid} lost across the reboot")
                got = served_search(srv, cx, text)
                check(nid in {i for i, _ in got},
                      f"acknowledged write {nid} not found by its text")
            out["acknowledged_survived"] = len(acked)
        finally:
            srv.stop()
    finally:
        TorchFlatIndex.insert_batch = orig_insert
    torch.cuda.empty_cache()
    say("13-serve", phase_s=time.monotonic() - t_phase, card=card, **out)


SERVE_MODULES = ("aiohttp", "grpc", "google.protobuf", "cryptography")


def serve_modules_missing():
    """The serving packages that do not import here (none is installed
    by this script)."""
    import importlib
    missing = []
    for name in SERVE_MODULES:
        try:
            importlib.import_module(name)
        except ModuleNotFoundError:
            missing.append(name)
    return missing


def phase_serve_without(dev, workdir, card, missing):
    """13-serve's fallback when a serving package is missing: on the same
    copied store, what runs without it: the snapshot boot (open_embedded,
    or Cortex.open without cryptography), warmup, MCP's LocalBackend
    tools, and the embed and search batchers through ServerState, whose
    hits equal the in-process search; then a reopen from the snapshot
    with every acknowledged write found."""
    import asyncio
    from cortex_tpu_torch import Cortex
    from cortex_tpu_torch.server.mcp import LocalBackend, McpServer
    from cortex_tpu_torch.server.state import ServerState
    npz = os.path.join(workdir, "bge_small_random.npz")
    data_dir = serve_data_dir(workdir)
    cfg = serve_config(data_dir, npz)

    def boot():
        if "cryptography" in missing:
            return Cortex.open(os.path.join(data_dir, "cortex.db"), cfg,
                               device=dev)
        from cortex_tpu_torch.api import open_embedded
        return open_embedded(cfg, device=dev)[0]
    t0 = time.monotonic()
    cx = boot()
    out = {"boot_snapshot_s": time.monotonic() - t0,
           "from_snapshot": cx._chain_bs is not None}
    check(out["from_snapshot"], "the boot rebuilt the index")
    t0 = time.monotonic()
    check(cx.warmup(), "warmup did not finish")
    out["warmup_s"] = time.monotonic() - t0
    words = encoder_words(ENC_SEED)[0]
    nodes = encoder_nodes(SERVE_UNGATED, ENC_SEED + 21, words)
    mcp = McpServer(LocalBackend(cx))
    for i, n in enumerate(nodes):
        res = mcp.handle({"jsonrpc": "2.0", "id": i, "method": "tools/call",
                          "params": {"name": "cortex_store", "arguments": {
                              "kind": n.kind, "title": n.title,
                              "body": n.body}}})
        check("result" in res, f"MCP store failed: {res}")
    cx.store_batch(nodes)
    acked = [(n.id, served_text(n.kind, n.title, n.body)) for n in nodes]
    queries = encoder_queries(nodes, words, SERVE_COMPARED, ENC_SEED + 22)
    state = ServerState(cortex=cx)
    state.enable_batched_admission()
    state.enable_batched_search()

    async def batched():
        raw = await asyncio.gather(*[state.search_batcher.search(q, K)
                                     for q in queries])
        await state.search_batcher.close()
        await state.batcher.close()
        return raw
    for q, raw in zip(queries, asyncio.run(batched())):
        same_served(in_process(cx, q), [(i, s) for i, s in raw],
                    "batched search")
    cx.close()
    cx = boot()
    check(cx._chain_bs is not None, "the reopen rebuilt the index")
    for nid, text in acked:
        check(cx.get_node(nid) is not None
              and nid in {i for i, _ in in_process(cx, text)},
              f"acknowledged write {nid} lost across the reopen")
    cx.close()
    say("13-serve-without", missing=missing, card=card,
        acknowledged_survived=len(acked), batched_searches=len(queries),
        **out)


# ------------------------------------------------------------ phase 14


def mesh_of(dev, name):
    """Phase 14's virtual mesh `name` (MESH_LAYOUTS) on the one card."""
    from cortex_tpu_torch.parallel import build_mesh
    n, replicas = MESH_LAYOUTS[name]
    return build_mesh(n, replicas=replicas, devices=[dev] * n)


def clone_host(src, dst):
    """Give the empty corpus dst the host contents of src row for row:
    the mirror, the id <-> row maps, the interners and the capacity (the
    bookkeeping 1M upserts would rebuild, copied); dst's next sync
    uploads it whole. Returns the seconds taken."""
    t0 = time.monotonic()
    for name in ("_emb_h", "_live_h", "_kind_h", "_agent_h"):
        setattr(dst, name, getattr(src, name).copy())
    dst._row_of = dict(src._row_of)
    dst._id_of = list(src._id_of)
    dst._free = list(src._free)
    dst._cap = src._cap
    for attr in ("kinds", "agents"):
        getattr(dst, attr)._code = dict(getattr(src, attr)._code)
        getattr(dst, attr)._name = list(getattr(src, attr)._name)
    if hasattr(dst, "_cluster_of"):
        for name in ("_cluster_of", "_slot_of", "_cluster_of2",
                     "_slot_of2"):
            setattr(dst, name, np.full(dst._cap, -1, np.int32))
    dst._full_resync = True
    dst._dirty = set()
    return time.monotonic() - t0


def count_swaps(want, got, what):
    """same_index_hits, and the ranks whose ids differ (near-ties)."""
    same_index_hits(want, got, what)
    return sum(1 for (a, _), (b, _) in zip(want, got) if a != b)


def recall_of(hits, truth):
    return float(np.mean([len({i for i, _ in h} & t) / K
                          for h, t in zip(hits, truth)]))


def mesh_hits(sharded, single, q_np, ov, oi, what):
    """Phase 14's check of one mesh index against the single-device
    index on the same rows (single's searches uncounted): the top-10 of
    phase 3's queries at batch 64 and one at a time, each rank's id
    equal but for near-ties and its score within NEAR_TIE, the oracle's
    top-10 too. Returns the ranks whose ids differ (near-ties)."""
    co = sharded._corpus
    got = sharded.search_batch(q_np, K)
    with uncounted():
        want = single.search_batch(q_np, K)
        want1 = [single.search_batch(q_np[b:b + 1], K)[0]
                 for b in range(8)]
    got1 = [sharded.search_batch(q_np[b:b + 1], K)[0] for b in range(8)]
    swaps = sum(count_swaps(w, g, f"{what} batch 64, query {b}")
                for b, (w, g) in enumerate(zip(want, got)))
    swaps += sum(count_swaps(w, g, f"{what} batch 1, query {b}")
                 for b, (w, g) in enumerate(zip(want1, got1)))
    for b in range(len(q_np)):
        hits_match_oracle(got[b], ov[b], oi[b], co._id_of, K)
    return swaps


def mesh_speed(name, sharded, q_np, q_lat, card, **extra):
    """A mesh index's speed (search_speed at MESH_RUNS x MESH_ROUNDS
    batches and MESH_LAT batch-1 queries), printed with `extra`."""
    qps, p50, p99 = search_speed(sharded, q_np, q_lat[:MESH_LAT],
                                 runs=MESH_RUNS, rounds=MESH_ROUNDS)
    mesh = sharded.mesh
    say("14-mesh-" + name, devices=mesh.size, virtual=mesh.virtual,
        mesh=sharded.index_info()["mesh"],
        batch64_qps_median=statistics.median(qps), batch64_qps_runs=qps,
        batch1_ms_p50=p50, batch1_ms_p99=p99,
        batch1_queries=min(MESH_LAT, len(q_lat)), card=card, **extra)


def phase_mesh_ivf(dev, index, q_np, q_lat, card):
    """Phase 14, IVF: on each of MESH_LAYOUTS, a ShardedIvfIndex over
    phase 3's rows (cloned from its index, with its clustering as boot
    hints: the same lists, packed, placed list by list on the shards and
    the kNN graph built anew with N1 from host chunks); at nprobe = nlist
    its top-10 equal to phase 3's index (and the oracle), then at the
    default nprobe its recall@10 refined and unrefined no lower than
    phase 3's index's at the same nprobe; the speed."""
    import torch
    from cortex_tpu_torch.parallel import ShardedIvfIndex
    co = index._corpus
    ov, oi = oracle_topk(co._emb_h, co._live_h, q_np, K, dev)
    truth = [{co._id_of[r] for r in oi[b][:K]} for b in range(len(q_np))]
    with uncounted():
        single = {ref: recall_of(index.search_batch(q_np, K, refine=ref),
                                 truth) for ref in (True, False)}
    for name in MESH_LAYOUTS:
        sharded = ShardedIvfIndex(index.dim, mesh_of(dev, name),
                                  graph_degree=co._graph_degree)
        sco = sharded._corpus
        clone_s = clone_host(co, sco)
        sco._boot_cent = co._centroids_h.copy()
        sco._boot_cluster = co._cluster_of.copy()
        sco._boot_cluster2 = co._cluster_of2.copy()
        t0 = time.monotonic()
        sco.sync()
        torch.cuda.synchronize()
        build_s = time.monotonic() - t0
        graph_s = wait_for_graph(sharded)
        check(np.array_equal(sco._centroids_h, co._centroids_h),
              "the mesh index did not take phase 3's clustering")
        recall = {ref: recall_of(sharded.search_batch(q_np, K, refine=ref),
                                 truth) for ref in (True, False)}
        for ref in (True, False):
            check(recall[ref] >= single[ref] - 1e-9,
                  f"{name} mesh IVF recall@10 {recall[ref]} below one "
                  f"device's {single[ref]} (refine={ref})")
        c = sco._centroids_h.shape[0]
        with full_probe(sharded), full_probe(index):
            swaps = mesh_hits(sharded, index, q_np, ov, oi, "mesh IVF "
                              + name)
        mesh_speed("ivf-" + name, sharded, q_np, q_lat, card,
                   full_probe_top10_equal_single=True, near_tie_swaps=swaps,
                   nlist=int(c), nprobe=int(co._nprobe(c)),
                lists_per_shard=int(c // sco._n_shard),
                clone_s=clone_s, build_s=build_s,
                graph_wait_s=graph_s, graph_wall_s=sco._graph_stats.get(
                    "wall_s"), recall_at_10=recall[True],
                recall_at_10_unrefined=recall[False],
                single_recall_at_10=single[True],
                single_recall_at_10_unrefined=single[False])
        del sharded, sco
        torch.cuda.empty_cache()


def phase_mesh_flat(dev, index, q_np, q_lat, card):
    """Phase 14, flat: on each of MESH_LAYOUTS, a ShardedFlatIndex over
    phase 5's rows (cloned from its index; a full upload to every shard):
    on `auto` (K1 on each shard, the merged candidates re-ranked on the
    host) and on the exact product, its top-10 equal to phase 5's index
    (K1 + K2; the exact product) and to the oracle, recall@10 >= 0.99;
    the speed."""
    import torch
    from cortex_tpu_torch.parallel import ShardedFlatIndex
    co = index._corpus
    ov, oi = oracle_topk(co._emb_h, co._live_h, q_np, K, dev)
    truth = [{co._id_of[r] for r in oi[b][:K]} for b in range(len(q_np))]
    for name in MESH_LAYOUTS:
        sharded = ShardedFlatIndex(index.dim, mesh_of(dev, name))
        sco = sharded._corpus
        clone_s = clone_host(co, sco)
        t0 = time.monotonic()
        sco.sync()
        torch.cuda.synchronize()
        upload_s = time.monotonic() - t0
        check(sharded.index_info()["resolved_path"] == "quant",
              f"the {name} mesh flat index does not resolve to quant")
        recall = recall_of(sharded.search_batch(q_np, K), truth)
        check(recall >= 0.99, f"{name} mesh flat recall@10 {recall}")
        with exact_path(sharded), exact_path(index):
            exact = mesh_hits(sharded, index, q_np, ov, oi,
                              "mesh flat exact " + name)
        swaps = mesh_hits(sharded, index, q_np, ov, oi, "mesh flat " + name)
        mesh_speed("flat-" + name, sharded, q_np, q_lat, card,
                   top10_equal_single=True, near_tie_swaps=swaps,
                   exact_top10_equal_single=True, exact_near_tie_swaps=exact,
                   clone_s=clone_s, upload_s=upload_s, recall_at_10=recall)
        del sharded, sco
        torch.cuda.empty_cache()


def phase_mesh_engine(dev, gen, x_h, card):
    """Phase 14, the engine step: sharded_engine_step on the 4-device
    virtual mesh over phase 3's 1M rows (shard_corpus), 64 queries and
    64 new rows, and DECAY_EDGES edges (phase 2's inputs, nothing
    exempt): its top-10 against the exact oracle, its decay bit-equal to
    D1's plain version with the step's constants (and the step's rule
    for days <= 0); its wall, and the sharded sweep alone (CUDA events,
    uncounted) beside D1 on one device."""
    import torch
    from cortex_tpu_torch.ops import decay
    from cortex_tpu_torch.parallel import shard_corpus, sharded_engine_step
    from cortex_tpu_torch.parallel.sharding import (ENGINE_DECAY,
                                                    sharded_decay)
    mesh = mesh_of(dev, "4")
    n = x_h.shape[0]
    rng = np.random.default_rng(14)
    pick = rng.choice(n, 2 * BATCH, replace=False)
    q = x_h[pick] + 0.05 * rng.standard_normal(
        (2 * BATCH, x_h.shape[1])).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t0 = time.monotonic()
    corpus, bias = shard_corpus(mesh, x_h, np.zeros(n, np.float32))
    torch.cuda.synchronize()
    shard_s = time.monotonic() - t0
    w, days, imp, _ = decay_inputs(dev, gen, DECAY_EDGES)
    t0 = time.monotonic()
    out = sharded_engine_step(mesh, corpus, bias, q[:BATCH], q[BATCH:], w,
                              days, imp, k=K)
    torch.cuda.synchronize()
    step_s = time.monotonic() - t0
    qv, qi, lv, li, link, new_w, delete = out
    ov, oi = oracle_topk(x_h, np.ones(n, bool), q, K, dev)
    for got_v, got_i, off in ((qv, qi, 0), (lv, li, BATCH)):
        gv, gi = got_v.cpu().numpy(), got_i.cpu().numpy()
        np.testing.assert_allclose(gv, ov[off:off + BATCH, :K],
                                   atol=SCORE_ATOL)
        for b in range(BATCH):
            for j in np.flatnonzero(gi[b] != oi[off + b, :K]):
                check(abs(ov[off + b, j] - ov[off + b, j + 1]) <= NEAR_TIE
                      or abs(ov[off + b, j] - ov[off + b, j - 1])
                      <= NEAR_TIE, f"engine step rank {j}: no near-tie")
    check(torch.equal(link, lv >= 0.75), "engine step link mask")
    thr = float(np.float32(ENGINE_DECAY["delete_threshold"]))
    want = decay.decay_sweep_plain(
        w, days, imp, torch.zeros_like(w, dtype=torch.bool),
        *(float(np.float32(v)) for v in (0.01, 0.8, 0.05, 0.05)))
    check(torch.equal(new_w, want[0]), "engine step new_w differs from "
          "D1's plain version")
    check(torch.equal(delete, torch.where(days > 0, want[1], want[0] < thr)),
          "engine step delete mask differs")
    idle_light = int(((days <= 0) & (w < thr)).sum())
    with uncounted():
        sweep_ms = time_ms(lambda: sharded_decay(mesh, w, days, imp), 10)
        one_ms = time_ms(lambda: decay.decay_sweep(
            w, days, imp, torch.zeros_like(w, dtype=torch.bool),
            prune_threshold=0.05, **ENGINE_DECAY), 10)
    say("14-mesh-engine-step", devices=mesh.size, virtual=mesh.virtual,
        corpus_rows=n, edges=DECAY_EDGES, shard_corpus_s=shard_s,
        step_s=step_s, top10_equal_oracle=True, decay_equal_plain=True,
        idle_light_edges_marked=idle_light, sharded_sweep_ms=sweep_ms,
        one_device_sweep_ms=one_ms, card=card)
    del corpus, bias, out, want
    torch.cuda.empty_cache()


def phase_mesh_cortex(dev, workdir, card):
    """Phase 14, Cortex: CortexConfig() with [embedding] sharded = true
    on SQLite and device=[dev] * 4 (a 4-device virtual mesh: K1 on each
    shard at this capacity) against a single-device Cortex on the same
    MESH_NODES nodes (its searches uncounted): MESH_SEARCHES searches and
    ten hybrid searches held by the reference's served criterion (the
    same hit set, the same top 1, the same scores: same_hits, so with
    hashed text's exact ties an id may differ only where scores tie);
    then close (the snapshot), reopen on the mesh from it, the same
    hits."""
    from cortex_tpu_torch import Cortex
    from cortex_tpu_torch.config import CortexConfig
    from cortex_tpu_torch.parallel import ShardedFlatIndex
    from cortex_tpu_torch.types import Edge, EdgeProvenance
    cfg = CortexConfig()
    cfg.embedding.sharded = True
    devices = [dev] * 4
    path = os.path.join(workdir, "mesh.db")
    nodes = seeded_nodes(MESH_NODES, 14)
    cx = Cortex.open(path, cfg, device=devices)
    check(isinstance(cx.index, ShardedFlatIndex)
          and cx.index.index_info()["mesh"] == {"shards": 4, "replicas": 1},
          "sharded = true on four devices did not build the mesh index")
    t0 = time.monotonic()
    ids = cx.store_batch(nodes)
    store_s = time.monotonic() - t0
    path_now = cx.index.index_info()["resolved_path"]
    check(path_now == "quant", f"the mesh Cortex resolves to {path_now}")
    prov = EdgeProvenance.manual("seed")
    edges = [Edge.new(ids[i], ids[i + 1], "related_to", 0.8, prov)
             for i in range(0, 200, 2)]
    for e in edges:
        cx.create_edge(e)
    with uncounted():
        twin = Cortex.in_memory(CortexConfig(), device=dev)
        twin.store_batch(nodes)
        for e in edges:
            twin.create_edge(e)
    queries = [nodes[i].title for i in range(0, MESH_NODES,
                                             MESH_NODES // MESH_SEARCHES)]

    def served_parity(got, want, what):
        # the reference's criterion, with hashed text's exact ties: the
        # same hit set but for ties at the cut-off, the same top 1 but
        # for a tie at the top, the same scores (same_hits)
        same_hits(want, got)
        check(got[0][1].id == want[0][1].id
              or abs(want[0][0] - want[1][0]) <= SCORE_ATOL,
              f"{what}: top 1 differs")

    def searches(c):
        return [c.search(q, 10, record_access=False) for q in queries]

    def hybrid(c):
        return [[(r.combined_score, r.node) for r in c.search_hybrid(
            queries[j], anchors=[ids[2 * j]], limit=10)]
            for j in range(10)]

    got = searches(cx)
    got_h = hybrid(cx)
    with uncounted():
        want = searches(twin)
        want_h = hybrid(twin)
    twin.close()
    for j, (g, w) in enumerate(zip(got, want)):
        served_parity(g, w, f"mesh Cortex search {j}")
    for j, (g, w) in enumerate(zip(got_h, want_h)):
        served_parity(g, w, f"mesh Cortex hybrid search {j}")
    t0 = time.monotonic()
    cx.close()
    close_s = time.monotonic() - t0
    t0 = time.monotonic()
    cx = Cortex.open(path, cfg, device=devices)
    reopen_s = time.monotonic() - t0
    try:
        check(cx._chain_bs is not None, "the mesh Cortex did not boot "
              "from its snapshot")
        check(isinstance(cx.index, ShardedFlatIndex), "reopened off the mesh")
        again = searches(cx)
        for j, (g, w) in enumerate(zip(again, got)):
            same_hits(w, g)
    finally:
        cx.close()
    say("14-mesh-cortex", nodes=MESH_NODES, devices=len(devices),
        virtual=True, resolved_path=path_now, store_batch_s=store_s,
        searches=len(queries), hybrid_searches=len(got_h),
        served_parity=True, close_s=close_s, snapshot_reopen_s=reopen_s,
        same_after_reopen=True, card=card)


def phase_mesh_dryrun(dev, card):
    """Phase 14, the port's dry run (multichip.dryrun_multichip) on a
    4-device virtual mesh: the engine step, the three serving routes,
    the 2 x 2 mesh and the composed server on both layouts."""
    from cortex_tpu_torch.multichip import dryrun_multichip
    t0 = time.monotonic()
    out = dryrun_multichip(4, devices=[dev] * 4)
    say("14-mesh-dryrun", seconds=time.monotonic() - t0, **out, card=card)


# ------------------------------------------------------------ phase 15


def fuzz_node(counter):
    """tests/test_model_fuzz.py's node for its counter."""
    from cortex_tpu_torch.types import Node, Source
    return Node.new("fact", f"Fuzz node {counter} flavor {counter % 7}",
                    f"Body long enough for checks, entry {counter}.",
                    Source(agent=f"a{counter % 3}"))


def model_fuzz(dev, seed):
    """Phase 15 (a), the reference's model fuzz (tests/test_model_fuzz.py
    run_fuzz) on the card: random store, update, delete and search
    through a flat Cortex whose searches run K1 + K2 (search_path
    "quant"), held after every REF_FUZZ_EVERY operations to a dict of
    live nodes: the stored live set, the index's membership, and no dead
    id in any hit. Returns its counts."""
    import random

    from cortex_tpu_torch.api import Cortex
    from cortex_tpu_torch.config import CortexConfig
    cfg = CortexConfig()
    cfg.embedding.search_path = "quant"
    rng = random.Random(seed)
    cx = Cortex.in_memory(cfg, device=dev)
    check(cx.index._corpus._choose_path(16) == "quant",
          "model fuzz: the flat index does not search through K1 + K2")
    live, counter, hits, bursts = {}, 0, 0, 0

    def agree():
        stored = {n.id for n in cx.list_nodes() if not n.deleted}
        check(stored == set(live), f"seed {seed}: stored set != oracle")
        check(len(cx.index) == len(live), f"seed {seed}: index size")
        check(all(nid in cx.index for nid in live),
              f"seed {seed}: a live node missing from the index")

    for step in range(REF_FUZZ_OPS):
        r = rng.random()
        if r < 0.45 or not live:
            counter += 1
            n = fuzz_node(counter)
            cx.store(n)
            live[n.id] = n.title
        elif r < 0.60:
            n = cx.get_node(rng.choice(list(live)))
            n.body = f"Updated body long enough, step {step}."
            cx.update_node(n)
        elif r < 0.80:
            nid = rng.choice(list(live))
            check(cx.delete_node(nid, hard=rng.random() < 0.5),
                  f"seed {seed}: delete_node({nid}) failed")
            del live[nid]
        else:
            got = cx.search(f"fuzz node flavor {step % 7}", limit=8,
                            record_access=False)
            hits += len(got)
            check(all(n.id in live for _, n in got),
                  f"seed {seed} step {step}: a dead node in the hits")
        if step % REF_FUZZ_EVERY == REF_FUZZ_EVERY - 1:
            agree()
            bursts += 1
    agree()
    cx.close()
    return {"seed": seed, "ops": REF_FUZZ_OPS, "checks": bursts + 1,
            "live": len(live), "hits": hits}


def ivf_fuzz(dev, seed):
    """Phase 15 (b), the reference's IVF fuzz (tests/test_ivf_fuzz.py) on
    the card: TorchIvfIndex at nprobe = nlist through random upserts,
    updates, removes, retrains and searches (kind filters, exclusions),
    each search against the port's BruteForceIndex: the same ids (ranks
    whose oracle scores lie within NEAR_TIE may swap, counted) and
    scores within SCORE_ATOL. Returns its counts."""
    from cortex_tpu_torch.vector import (BruteForceIndex, TorchIvfIndex,
                                         VectorFilter)
    rng = np.random.default_rng(seed)
    ivf = TorchIvfIndex(IVF_FUZZ_DIM, nlist=IVF_FUZZ_NLIST,
                        nprobe=IVF_FUZZ_NLIST, device=dev)
    oracle = BruteForceIndex(IVF_FUZZ_DIM)
    live, next_id, kinds = {}, 0, ["fact", "event", "decision"]
    searches, swaps = 0, 0

    def vec():
        return rng.standard_normal(IVF_FUZZ_DIM).astype(np.float32)

    for step in range(IVF_FUZZ_STEPS):
        op = rng.choice(["insert", "insert", "insert", "update", "remove",
                         "rebuild", "search", "search"])
        if op == "insert" or (op in ("update", "remove") and not live):
            nid, next_id = f"n{next_id}", next_id + 1
            v, kind = vec(), kinds[int(rng.integers(len(kinds)))]
            ivf.insert(nid, v, kind=kind, source_agent="f")
            oracle.insert(nid, v, kind=kind, source_agent="f")
            live[nid] = kind
        elif op == "update":
            nid, v = str(rng.choice(list(live))), vec()
            ivf.insert(nid, v, kind=live[nid], source_agent="f")
            oracle.insert(nid, v, kind=live[nid], source_agent="f")
        elif op == "remove":
            nid = str(rng.choice(list(live)))
            check(ivf.remove(nid) == oracle.remove(nid),
                  f"seed {seed} step {step}: remove({nid}) disagrees")
            live.pop(nid)
        elif op == "rebuild":
            ivf.retrain()
        else:
            q, k = vec()[None, :], int(rng.integers(1, 12))
            flt = None
            if rng.random() < 0.3:
                flt = VectorFilter(kinds=[kinds[int(rng.integers(3))]])
            if rng.random() < 0.15 and live:
                flt = flt or VectorFilter()
                flt.exclude_ids = list(rng.choice(
                    list(live), size=min(3, len(live)), replace=False))
            got = ivf.search_batch(q, k, flt)[0]
            want = oracle.search_batch(q, k, flt)[0]
            ws = [s for _, s in want]
            check(len(got) == len(want),
                  f"seed {seed} step {step}: {len(got)} hits, oracle "
                  f"{len(want)}")
            for j, ((g, _), (w, _)) in enumerate(zip(got, want)):
                if g != w:
                    check(any(abs(ws[j] - ws[o]) <= NEAR_TIE
                              for o in (j - 1, j + 1) if 0 <= o < len(ws)),
                          f"seed {seed} step {step}: rank {j} {g} != {w}")
                    swaps += 1
            np.testing.assert_allclose([s for _, s in got], ws,
                                       atol=SCORE_ATOL)
            searches += 1
    ivf.close()
    return {"seed": seed, "steps": IVF_FUZZ_STEPS, "searches": searches,
            "near_tie_swaps": swaps, "live": len(live)}


def tie_order(dev, path):
    """Phase 15 (c), ROADMAP C's open item: a TorchFlatIndex of TIE_ROWS
    rows, each of TIE_ROWS // 3 rows stored three times under ids out of
    slot order, so that scores tie exactly; the same TIE_QUERIES queries
    (a third of them stored rows) searched at each batch of TIE_BATCHES
    return the same ids in the same order and the same scores. Returns
    the path searched and the exact ties seen in the top k."""
    from cortex_tpu_torch.vector import TorchFlatIndex
    rng = np.random.default_rng(15)
    base = rng.standard_normal((TIE_ROWS // 3, TIE_DIM)).astype(np.float32)
    rows = np.concatenate([base, base[::-1], base])
    ids = [f"t{(7919 * j) % TIE_ROWS:05d}" for j in range(TIE_ROWS)]
    index = TorchFlatIndex(TIE_DIM, search_path=path, device=dev)
    index.insert_batch(ids, rows)
    q = np.concatenate([base[:TIE_QUERIES // 3], rng.standard_normal(
        (TIE_QUERIES - TIE_QUERIES // 3, TIE_DIM)).astype(np.float32)])
    results = {}
    for b in TIE_BATCHES:
        results[b] = [h for s in range(0, TIE_QUERIES, b)
                      for h in index.search_batch(q[s:s + b], TIE_K)]
    first = results[TIE_BATCHES[0]]
    for b in TIE_BATCHES[1:]:
        for j, (w, g) in enumerate(zip(first, results[b])):
            check([i for i, _ in g] == [i for i, _ in w],
                  f"tie order ({path}): query {j} at batch {b} "
                  f"{[i for i, _ in g]} != batch {TIE_BATCHES[0]} "
                  f"{[i for i, _ in w]}")
            np.testing.assert_allclose([s for _, s in g],
                                       [s for _, s in w], atol=SCORE_ATOL)
    ties = sum(int(sum(a[1] == b_[1] for a, b_ in zip(h, h[1:])))
               for h in first)
    check(ties > 0, f"tie order ({path}): no exact tie in the top {TIE_K}")
    resolved, cap = index._corpus._choose_path(16), index._corpus._cap
    index.close()
    return {"search_path": path, "resolved": resolved, "cap": cap,
            "queries": TIE_QUERIES, "batches": list(TIE_BATCHES),
            "exact_ties": ties}


def entry_on_card(dev):
    """Phase 15 (d): entry.entry() on the card, its step held to the same
    step on the CPU: equal top-K ids where no two scores of a row lie
    within NEAR_TIE, scores within SCORE_ATOL."""
    from cortex_tpu_torch.entry import entry
    step, args = entry(dev)
    t0 = time.monotonic()
    v, i = (t.cpu().numpy() for t in step(*args))
    ms = (time.monotonic() - t0) * 1e3
    step_c, args_c = entry("cpu")
    want_v, want_i = (t.numpy() for t in step_c(*args_c))
    err = float(np.abs(v - want_v).max())
    check(err <= SCORE_ATOL, f"entry: scores {err} from the CPU's")
    gap = np.abs(np.diff(want_v, axis=1)) > NEAR_TIE
    pad = np.ones((want_v.shape[0], 1), bool)
    decided = np.concatenate([pad, gap], 1) & np.concatenate([gap, pad], 1)
    check((i[decided] == want_i[decided]).all(),
          "entry: top-k ids differ from the CPU's")
    return {"shape": list(v.shape), "max_abs_err": err,
            "decided": int(decided.sum()), "first_call_ms": ms}


def phase_reference_cases(dev, card):
    """Phase 15, the reference's cases on the card: (a) its model fuzz,
    (b) its IVF fuzz, (c) exact-tie order across batches, (d) entry()."""
    t0 = time.monotonic()
    out = {"model_fuzz": [model_fuzz(dev, s) for s in REF_FUZZ_SEEDS]}
    out["ivf_fuzz"] = [ivf_fuzz(dev, s) for s in IVF_FUZZ_SEEDS]
    out["tie_order"] = [tie_order(dev, p) for p in ("auto", "exact")]
    say("15-reference-cases", seconds=time.monotonic() - t0, **out,
        card=card)
    t0 = time.monotonic()
    out = entry_on_card(dev)
    say("15-entry", seconds=time.monotonic() - t0, **out, card=card)


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
    t_run = time.monotonic()
    t0 = time.monotonic()
    lib = build.build_library()
    build.load_ops()
    say("1-build", seconds=time.monotonic() - t0, library=str(lib),
        torch=torch.__version__, cuda=torch.version.cuda, card=card,
        native_rerank=native.available())

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    kc, fc, knc = KernelCheck(), FlatKernelCheck(), KnnKernelCheck()
    if argv == ["--profile"]:
        index, q_np, q_lat, _, rows = phase_index(dev, N_BIG, D_BIG, gen,
                                                  kc)
        profile_index("ivf", index, q_np, q_lat, card)
        profile_knn_parts(index, card)
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
        profile_e1_forms(dev, gen, card)
        check_no_reference_import()
        print(card, flush=True)
        return 0
    check_synthetic(kc, dev, gen, 16, 37, 100, 5, 3)        # small, odd
    check_synthetic(kc, dev, gen, 144, 192, 384, BATCH, 18)  # phase 4's
    check_flat_synthetic(fc, dev, gen, 3001, 37, 5)          # small, odd
    check_flat_synthetic(fc, dev, gen, 32768, 384, BATCH)    # phase 6's
    gc = GraphKernelCheck()
    check_graph_small(gc, dev, gen)
    knn_lists = check_knn_synthetic(knc, dev, gen)
    say("2-kernel-small", cases=kc.cases, max_abs_err=kc.max_abs_err,
        flat_cases=fc.cases, k1_max_abs_err=fc.k1_err,
        k2_max_abs_err=fc.k2_err, graph_cases=gc.cases,
        graph_overflows=gc.overflows, graph_max_abs_err=gc.max_abs_err,
        knn_cases=knc.cases, knn_max_abs_err=knc.max_abs_err)
    say("2-kernel-knn-10M-lists", **knn_lists["l4096"], card=card)
    say("2-kernel-knn-wide-lists", **knn_lists["l8192"], card=card)
    dc = DecayCheck()
    perf = {"decay_sweep": check_decay(dc, dev, gen, card)}
    rc = RetentionCheck()
    perf["retention_eligibility"] = check_retention(rc, dev, gen, card)
    ec = EncoderKernelCheck()
    perf.update(check_encoder_kernels(ec, dev, gen, card))
    perf.update(check_graph_big(gc, dev, gen, card))
    torch.cuda.empty_cache()

    # nine main paths, each read just after it: IVF (3-4, from the build:
    # its kNN graph runs N1, the tuner K1; with 13's IVF snapshot boot),
    # flat (5-6, and 13's flat snapshot boot after 9), graph (7-8),
    # linker (9-10), encoder (11), services (12, in three parts: the
    # IVF gate after phase 4, the store's services after phase 10, the
    # flat gate after phase 11), serve (13-serve, after 12's flat
    # gate), mesh (14, in three parts) and reference-cases (15, last);
    # 9 runs between 7 and 6 because it needs phase 5's index and phase
    # 7's storage
    ivf = ("probed_scores", "block_knn", "quant_candidates")
    flat, graph = ("quant_candidates", "quant_rerank"), (
        "frontier_bfs", "frontier_bfs_compact", "bfs_relax")
    linker = ("quant_candidates", "quant_rerank", "decay_sweep")
    encoder = ("add_layer_norm", "embed_layer_norm", "masked_attention",
               "quant_candidates", "quant_rerank", "probed_scores")
    services = ("probed_scores", "quant_candidates", "quant_rerank",
                "add_layer_norm", "embed_layer_norm", "masked_attention",
                "retention_eligibility")
    serve = ("add_layer_norm", "embed_layer_norm", "masked_attention",
             "quant_candidates", "quant_rerank")
    mesh = ("probed_scores", "quant_candidates", "decay_sweep", "block_knn")
    refcases = ("quant_candidates", "quant_rerank", "probed_scores",
                "block_knn")
    launches = {"ivf": {}, "flat": {}, "graph": {}, "linker": {},
                "encoder": {}, "services": {}, "serve": {}, "mesh": {},
                "reference-cases": {}}

    def take(path, names):
        counts = launch_counts()
        for n in names:
            launches[path][n] = launches[path].get(n, 0) + counts[n]

    reset_launches()                          # the IVF main path
    index, q_np, q_lat, ivf_perf, rows = phase_index(dev, N_BIG, D_BIG,
                                                     gen, kc, knc, fc)
    perf["probed_scores"] = ivf_perf["probed_scores"]
    perf["block_knn"] = ivf_perf["block_knn"]
    take("ivf", ivf)
    mesh_s = {}                               # phase 14's parts' seconds
    t14 = time.monotonic()
    reset_launches(mesh)                      # the mesh path (14), IVF
    phase_mesh_ivf(dev, index, q_np, q_lat, card)
    take("mesh", mesh)
    mesh_s["ivf"] = time.monotonic() - t14
    reset_launches(ivf)
    phase_search(index, q_np, q_lat, gen, dev, card)
    phase_snapshot("ivf", index, q_np, gen, dev, card)
    del index
    torch.cuda.empty_cache()
    index = phase_tuned(dev, rows, card)
    del index
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as workdir:
        phase_cortex(dev, workdir)
    defaults = phase_cortex_defaults(dev)
    take("ivf", ivf)
    reset_launches(services)                  # the services path (12)
    phase_gate_ivf(defaults, card)
    take("services", services)
    defaults.close()
    del defaults

    index, flat_perf = phase_flat_build(dev, rows, fc)
    perf.update(flat_perf)
    perf["quant_candidates"][f"b{TUNE_QUERIES}_cand{TUNE_CAND}_tuner"] = \
        ivf_perf["k1_tuner"]
    x_h = rows[0]
    rows = (None, *rows[1:3], None, rows[4])   # phase 7: ids, kinds, member
    t14 = time.monotonic()
    reset_launches(mesh)                      # the mesh path (14), flat
    phase_mesh_flat(dev, index, q_np, q_lat, card)
    gen14 = torch.Generator(device=dev)
    gen14.manual_seed(14)
    phase_mesh_engine(dev, gen14, x_h, card)
    take("mesh", mesh)
    mesh_s["flat_and_engine"] = time.monotonic() - t14
    torch.cuda.empty_cache()
    reset_launches()                          # the flat main path
    phase_flat_search(index, q_np, q_lat, gen, dev, card)
    take("flat", flat)
    reset_launches(flat + graph)              # the graph main path
    storage = phase_hybrid(dev, index, rows, gc, card)
    take("graph", flat + graph)
    reset_launches(linker)                    # the linker main path
    phase_linker(dev, index, storage, x_h, card)
    take("linker", linker)
    reset_launches(flat)
    phase_snapshot("flat", index, q_np, gen, dev, card)
    take("flat", flat)
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
        reset_launches(services)
        phase_services_store(dev, workdir, card)
        take("services", services)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as workdir:
        reset_launches(encoder)
        phase_encoder(dev, workdir, card)
        take("encoder", encoder)
        reset_launches(services)
        phase_gate_flat(dev, workdir, card)
        take("services", services)
        missing = serve_modules_missing()
        reset_launches(serve)
        if missing:
            say("13-serve-modules", missing=missing)
            phase_serve_without(dev, workdir, card, missing)
        else:
            phase_serve(dev, workdir, card)
        take("serve", serve)
    t14 = time.monotonic()
    with tempfile.TemporaryDirectory() as workdir:
        reset_launches(mesh)                  # the mesh path (14), Cortex
        phase_mesh_cortex(dev, workdir, card)
        phase_mesh_dryrun(dev, card)
        take("mesh", mesh)
    mesh_s["cortex_and_dryrun"] = time.monotonic() - t14
    say("14-mesh", seconds=sum(mesh_s.values()), parts_s=mesh_s,
        launches=launches["mesh"], card=card)
    reset_launches(refcases)                  # the reference's cases (15)
    phase_reference_cases(dev, card)
    take("reference-cases", refcases)
    for path, counts in launches.items():
        for name, n in counts.items():
            check(n > 0, f"the {path} main path never launched {name}")

    errs = {"probed_scores": kc.max_abs_err, "quant_candidates": fc.k1_err,
            "quant_rerank": fc.k2_err, "decay_sweep": dc.max_abs_err,
            "add_layer_norm": ec.e1_err, "embed_layer_norm": ec.emb_err,
            "masked_attention": ec.e2_err,
            "block_knn": knc.max_abs_err,
            "retention_eligibility": rc.max_abs_err, **gc.max_abs_err}
    main_shapes = {"probed_scores": (f"b{BATCH}", "b1"),
                   "quant_candidates": (f"b{BATCH}_cand{FLAT_CANDS[0]}",
                                        f"b1_cand{FLAT_CANDS[0]}"),
                   "quant_rerank": (f"b{BATCH}", "b1"),
                   "frontier_bfs": ("a1_h3", None),
                   "frontier_bfs_compact": ("a1_h3", None),
                   "bfs_relax": ("a1_r3", None),
                   "decay_sweep": ("e10M", None),
                   "add_layer_norm": ("b64_s128", "b1_s32"),
                   "embed_layer_norm": ("b64_s128", "b1_s32"),
                   "masked_attention": ("b64_s128", "b1_s32"),
                   "block_knn": (f"c{KNN_CHUNK}_r{GRAPH_DEGREE}", None),
                   "retention_eligibility": ("n10M", None)}
    say("2-bounds", card=card, **{
        name: {shape: {k: t[k] for k in (
            "ms", "bound_ms", "bound_by", "share_of_bound", "tc_bound_ms",
            "share_of_tc_bound") if k in t}
               for shape, t in perf[name].items()}
        for name in KERNELS})
    check_no_reference_import()
    say("done", seconds=time.monotonic() - t_run, card=card)
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
        entry.update({k: t[k] for k in ("share_of_bound", "replaced_ms")
                      if k in t})
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
