"""IVF (inverted-file) index of the port: the sublinear search option.

Counterpart of cortex_tpu/vector/ivf.py (IvfCorpus, TpuIvfIndex):

  * build: spherical k-means on the device gives C centroids; every live
    row is packed into a slot of a padded [C, L, d] int8 block layout
    (centered quantization, ranking-invariant), with per-slot [C, L]
    planes: rinv (f32), slot_rows, kind_sl, agent_sl (int32). Boundary
    rows are spilled into their second-choice cluster's spare slots.
    The packing, spill and quantization are the reference's numpy code,
    so the same clustering gives the same layout slot for slot.
  * tuning ([embedding] ivf_target_recall > 0, nprobe auto): sampled
    rows as self-queries, their top-10 by the layout's own int8 scores
    (K1, ops/similarity.py::quant_candidates, over chunks of the
    flattened layout), the probe-hit curve over a ladder of nprobe, the
    smallest rung that meets the target, then the delivered recall
    through the real search and a wider candidate list while that helps.
  * the kNN graph ([embedding] ivf_graph_degree > 0, vector/knn_graph.py):
    each row's nearest rows within its cluster(s), from N1
    (ops/knn_graph.py::block_knn); built inline for small layouts and
    on a background thread (on a CUDA stream of its own) for large ones.
  * search: q @ centroids.T, top-nprobe clusters per query, the
    probed-block scan (ops/ivf_gather.py::probed_scores, a CUDA kernel
    on the card), top-`cand`, the query descale, spill dedup. The
    candidates, widened through the kNN graph (_expand_candidates), then
    get the exact fp32 host re-rank of DeviceCorpus._finish_topk, so
    final scores are fp32-true and the only approximation is candidate
    membership.

Left out (ROADMAP queue A): snapshots and compaction (item 3), the
sharded index (item 8) and the warm-ahead compiles (nothing to compile).
Incremental updates write the layout in place (index_put_ / torch.cat)
under the corpus lock; the background graph build reads host copies of
the planes, never the ones being written.

One named deviation from the reference (ROADMAP queue C):
_measure_delivered takes a query's candidates from its valid entries and
counts a query with none as all misses; the reference reads rows >= 0
(invalid entries come back as row 0) and skips a query with none
(cortex_tpu/vector/ivf.py:1290-1292).
"""

from __future__ import annotations

import logging
import math
import threading
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops.ivf_gather import probed_scores
from ..ops.similarity import (NEG_INF, quant_candidates, quantize_queries,
                              quantize_rows_centered)
from ..utils.device import resolve_device
from . import knn_graph
from .index import TorchFlatIndex
from .shard import (DeviceCorpus, MAX_EXCLUDE, MAX_FILTER_KINDS,
                    NO_FILTER, PAD_CODE)

log = logging.getLogger("cortex.ivf")

#: auto-nlist ceiling: past this the centroid scan itself starts to
#: cost like a small flat scan (C*d per query)
MAX_AUTO_NLIST = 8192
#: slot slack over perfectly-balanced fill — spill headroom for k-means
#: imbalance and incremental inserts between retrains
SLOT_SLACK = 1.3
#: retrain when the live count drifts this far from the trained count
RETRAIN_GROWTH = 2.0
#: device bytes the per-query [p*L] score/row planes of one dispatch may
#: take; larger batches run as a loop over query chunks
GATHER_BUDGET_BYTES = 2 << 30
#: rows per k-means assignment pass (bounds the [rows, C] score plane)
ASSIGN_CHUNK = 1 << 18
#: graph refinement frontier: the top-E int8-ranked candidates whose
#: kNN-graph neighbours join the exact re-rank (~E * degree extra host
#: re-ranked rows a query)
REFINE_FRONTIER = 16
#: expansion hops: 1 = neighbours of found candidates; 2+ re-expands from
#: the exact-scored top of each hop's additions
REFINE_HOPS = 1
#: recall-target tuning: corpus rows sampled as self-queries at (re)train
TUNE_SAMPLES = 256
#: the recall@k the tuner measures (the serving metric's k)
TUNE_TRUTH_K = 10
#: layouts of at least this many slots (C * L) build their kNN graph on a
#: background thread; smaller ones inline, under the build's lock
WARM_MIN_SLOTS = 1 << 16


# ---------------------------------------------------------------- training


def kmeans(data: torch.Tensor, init: torch.Tensor, *,
           iters: int) -> torch.Tensor:
    """Spherical k-means (Lloyd) on the data's device. data [S, d]
    unit-norm fp32; init [C, d]. Centroids re-normalize each step;
    empty clusters keep their previous centroid."""
    cent = init.clone()
    c = cent.shape[0]
    for _ in range(iters):
        assign = torch.argmax(data @ cent.T, dim=1)
        sums = torch.zeros_like(cent).index_add_(0, assign, data)
        counts = torch.bincount(assign, minlength=c)
        fresh = sums / sums.norm(dim=1, keepdim=True).clamp_min(1e-12)
        cent = torch.where(counts[:, None] > 0, fresh, cent)
    return cent


def assign_top2(data: torch.Tensor, cent: torch.Tensor):
    """Per-row best-2 clusters and their scores (a1, a2, v1, v2) — the
    overflow fallback of capped packing and the (choice, margin) inputs
    of spill packing."""
    s = data @ cent.T
    a1 = torch.argmax(s, dim=1)
    v1 = s.gather(1, a1[:, None])[:, 0]
    if cent.shape[0] == 1:                # no second choice exists
        return a1, a1, v1, v1
    s.scatter_(1, a1[:, None], float("-inf"))
    a2 = torch.argmax(s, dim=1)
    v2 = s.gather(1, a2[:, None])[:, 0]
    return a1, a2, v1, v2


# ----------------------------------------------------------------- search


def descale_valid(v: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """Divide the per-query scale out of valid entries ONLY: dividing
    the NEG_INF sentinel by qs would lift it above the -1e29 dead-hit
    threshold."""
    return torch.where(v > NEG_INF / 2, v / qs[:, None], v)


def dedup_rows(v: torch.Tensor, rows: torch.Tensor):
    """Keep the first (highest int8 score) copy of a spilled row that
    surfaces twice in a candidate list; later copies go to NEG_INF."""
    cand = rows.shape[1]
    earlier = torch.ones((cand, cand), dtype=torch.bool,
                         device=rows.device).tril(-1)
    dup = ((rows[:, :, None] == rows[:, None, :]) & earlier).any(dim=2)
    v = torch.where(dup, torch.full_like(v, NEG_INF), v)
    return v, torch.where(v > -1e29, rows, torch.zeros_like(rows))


def apply_host_bias(s: torch.Tensor, rows: torch.Tensor,
                    host_bias: torch.Tensor) -> torch.Tensor:
    """Add the exact [cap] host bias to unfiltered kernel scores,
    gathered per slot by global row (masked slots stay NEG_INF)."""
    slot_bias = host_bias[rows.clamp(0, host_bias.shape[0] - 1).long()]
    return s + torch.where(s > NEG_INF / 2, slot_bias,
                           torch.zeros_like(slot_bias))


def ivf_search(layout, q: torch.Tensor, ak, aa, ex, *, p: int, cand: int,
               filtered: bool, dedup: bool, host_bias=None):
    """Probe + scan + top-cand for normalized queries q [B, d] on the
    layout's device. layout = (cent, emb_i8, rinv_sl, slot_rows, kind_sl,
    agent_sl). With host_bias (the exact [cap] f32 bias of an overflowing
    filter) the kernel runs unfiltered and the bias is gathered per
    candidate slot by global row. Returns (values [B, cand'] descaled,
    rows [B, cand'] int32, 0 where invalid)."""
    cent, emb_i8, rinv_sl, slot_rows, kind_sl, agent_sl = layout
    probe = torch.topk(q @ cent.T, p, dim=1).indices.to(torch.int32)
    l = emb_i8.shape[1]
    cc = min(cand, p * l)
    per_q = 2 * 2 * 4 * p * l + (2 * cc * cc if dedup else 0)
    qc = max(1, min(q.shape[0], GATHER_BUDGET_BYTES // per_q))
    vs, rs = [], []
    for s0 in range(0, q.shape[0], qc):
        qq, pr = q[s0:s0 + qc], probe[s0:s0 + qc]
        qi8, qs = quantize_queries(qq)
        s, rows = probed_scores(emb_i8, rinv_sl, slot_rows, kind_sl,
                                agent_sl, pr, qi8, ak, aa, ex,
                                filtered=filtered)
        if host_bias is not None:
            s = apply_host_bias(s, rows, host_bias)
        v, idx = torch.topk(s, cc, dim=1)
        r = torch.gather(rows, 1, idx)
        v = descale_valid(v, qs)
        if dedup:
            v, r = dedup_rows(v, r)
        vs.append(v)
        rs.append(torch.where(v > -1e29, r, torch.zeros_like(r)))
    return torch.cat(vs), torch.cat(rs)


class IvfCorpus(DeviceCorpus):
    """DeviceCorpus whose device layout is the clustered [C, L, d] block
    structure; candidate generation runs the probed-block kernel,
    everything downstream is inherited."""

    def __init__(self, dim: int, *, nlist: int = 0, nprobe: int = 0,
                 spill: float = 1.0, graph_degree: int = 32,
                 target_recall: float = 0.0, device):
        super().__init__(dim, device=device)
        self._nlist_cfg = int(nlist)          # 0 = auto (~sqrt(N))
        self._nprobe_cfg = int(nprobe)        # 0 = auto (C/8, >= 8)
        #: recall-target nprobe tuning (_tune_nprobe): > 0 with nprobe
        #: auto measures the probe-hit curve at each fresh (re)train and
        #: serves the smallest ladder nprobe that meets the target
        self._target_recall = min(1.0, max(0.0, float(target_recall)))
        self._nprobe_tuned = 0                # 0 = not tuned
        self._tune_curve: list = []           # last measured (p, recall)
        #: candidate-width escalation: x2 (up to x4) while the delivered
        #: recall misses the target and widening helps
        self._cand_boost = 1
        self._delivered_recall: Optional[float] = None
        # carried-over tuning (load_jax_state), consumed by the next build
        self._boot_nprobe_tuned = 0
        self._boot_tune_curve: Optional[list] = None
        self._boot_cand_boost = 0
        self._boot_delivered: Optional[float] = None
        #: what index_info serves: one dict, swapped whole (_publish_info)
        self._info_pub: dict = {"trained": False}
        #: kNN-graph refinement degree (vector/knn_graph.py); 0 disables
        self._graph_degree = max(0, int(graph_degree))
        self._nbrs_h: Optional[np.ndarray] = None     # [cap, degree]
        self._boot_nbrs: Optional[np.ndarray] = None  # carried over
        #: background builds: seq invalidates in-flight builds across
        #: rebuilds; stale collects rows mutated while one is in flight,
        #: whose out-edges the swap masks
        self._graph_seq = 0
        self._graph_inflight = False
        #: the background graph build's thread (release() joins it)
        self._graph_thread: Optional[threading.Thread] = None
        self._graph_stale: set = set()
        #: the last graph build's timings (build_knn_graph's stats, plus
        #: wall_s and background)
        self._graph_stats: dict = {}
        #: why the last background build left the graph off (index_info's
        #: graph_error); None while none failed since the last rebuild
        self._graph_error: Optional[str] = None
        #: fraction of the layout's post-reserve slack filled with
        #: spilled duplicates of boundary rows (0 disables)
        self._spill = min(1.0, max(0.0, float(spill)))
        #: (cent, emb_i8, rinv_sl, slot_rows, kind_sl, agent_sl) tensors
        self._ivf_dev: Optional[Tuple[torch.Tensor, ...]] = None
        self._centroids_h: Optional[np.ndarray] = None
        self._cluster_of = np.full((0,), -1, np.int32)   # [cap] by row
        self._slot_of = np.full((0,), -1, np.int32)      # [cap] by row
        # spill copy placement, -1 when a row has no second slot
        self._cluster_of2 = np.full((0,), -1, np.int32)
        self._slot_of2 = np.full((0,), -1, np.int32)
        self._cluster_free: List[List[int]] = []
        self._slot_cap = 0                    # L
        self._trained_live = 0
        #: True while the layout may hold spilled duplicate slots
        self._has_spill = False
        # carried-over clustering (load_jax_state), consumed by the next
        # _build_ivf so it skips k-means
        self._boot_cent: Optional[np.ndarray] = None
        self._boot_cluster: Optional[np.ndarray] = None
        self._boot_cluster2: Optional[np.ndarray] = None

    def load_jax_state(self, st) -> None:
        """Load the dict that cortex_tpu's IvfCorpus.state() returns (ids,
        vectors, kinds, agents, ivf_centroids, ivf_cluster, ivf_cluster2,
        and when present ivf_nbrs, ivf_nprobe_tuned, ivf_cand_boost,
        ivf_delivered, ivf_tune_curve; all numpy) the way TpuIvfIndex.load
        does: rows in `ids` order, then the clustering, the tuned nprobe
        and the kNN graph (id-relative, remapped to this corpus's rows) as
        one-shot hints for the next build. Loaded into an empty corpus,
        the build then packs the same [C, L, d] layout, slot for slot,
        as cortex_tpu's index loaded from the same state, and serves the
        same tuned nprobe and graph."""
        super().load_jax_state(st)
        ids = [str(i) for i in st["ids"]]
        cl = np.asarray(st["ivf_cluster"], np.int32)
        cl2 = np.asarray(st.get("ivf_cluster2",
                                np.full(len(cl), -1, np.int32)), np.int32)
        with self._lock:
            boot = np.full(self._cap, -1, np.int32)
            boot2 = np.full(self._cap, -1, np.int32)
            rows_new = np.empty(len(ids), np.int64)
            for j, nid in enumerate(ids):
                r = self._row_of[nid]
                boot[r] = cl[j]
                boot2[r] = cl2[j]
                rows_new[j] = r
            self._boot_cent = np.asarray(st["ivf_centroids"], np.float32)
            self._boot_cluster = boot
            self._boot_cluster2 = boot2
            if "ivf_nprobe_tuned" in st:
                self._boot_nprobe_tuned = int(st["ivf_nprobe_tuned"])
                if "ivf_tune_curve" in st:
                    self._boot_tune_curve = [
                        (int(p), float(r)) for p, r in st["ivf_tune_curve"]]
                if "ivf_cand_boost" in st:
                    self._boot_cand_boost = int(st["ivf_cand_boost"])
                if "ivf_delivered" in st:
                    self._boot_delivered = float(st["ivf_delivered"])
            if "ivf_nbrs" in st and self._graph_degree > 0:
                # positions in st["ids"] -> this corpus's rows
                nbp = np.asarray(st["ivf_nbrs"], np.int32)
                tgt = np.where(nbp >= 0, rows_new[np.where(nbp >= 0, nbp, 0)],
                               -1).astype(np.int32)
                bn = np.full((self._cap, nbp.shape[1]), -1, np.int32)
                bn[rows_new] = tgt
                self._boot_nbrs = bn

    # -------------------------------------------------------- bookkeeping
    def _mask_boot_hint(self, row: int) -> None:
        """Drop the carried-over cluster hint and graph row of a mutated
        row: its vector (or its node) changed, so it re-assigns fresh at
        the next build. Callers hold the corpus lock."""
        for bc in (self._boot_cluster, self._boot_cluster2, self._boot_nbrs):
            if bc is not None and 0 <= row < len(bc):
                bc[row] = -1

    def _mask_graph_row(self, row: int) -> None:
        """Drop a mutated row's out-edges: its vector changed (or the row
        was freed), so its list no longer describes it. In-edges that
        point at it stay: expansion re-checks liveness and filters, and
        the exact re-rank scores the current vector, so a stale edge
        costs one wasted candidate, never a wrong result. Callers hold
        the corpus lock."""
        nb = self._nbrs_h
        if nb is not None and 0 <= row < len(nb):
            nb[row] = -1
        if self._graph_inflight:
            self._graph_stale.add(row)

    def upsert_batch(self, ids, vectors, kinds, agents) -> None:
        # the write and the masking under one lock hold: a search's sync
        # in between could consume the still-unmasked one-shot hints
        with self._lock:
            super().upsert_batch(ids, vectors, kinds, agents)
            if (self._boot_cluster is not None or self._boot_nbrs is not None
                    or self._nbrs_h is not None or self._graph_inflight):
                for nid in ids:
                    r = self._row_of[nid]
                    self._mask_boot_hint(r)
                    self._mask_graph_row(r)

    def remove(self, node_id: str) -> bool:
        with self._lock:
            row = self._row_of.get(node_id)
            out = super().remove(node_id)
            if out:
                self._mask_boot_hint(row)
                self._mask_graph_row(row)
            return out

    def _grow(self, need: int) -> None:
        old = self._cap
        super()._grow(need)
        pad = self._cap - old
        if pad > 0:
            fill = np.full(pad, -1, np.int32)
            self._cluster_of = np.concatenate([self._cluster_of, fill])
            self._slot_of = np.concatenate([self._slot_of, fill])
            self._cluster_of2 = np.concatenate([self._cluster_of2, fill])
            self._slot_of2 = np.concatenate([self._slot_of2, fill])
            if self._nbrs_h is not None:
                self._nbrs_h = np.concatenate([self._nbrs_h, np.full(
                    (pad, self._nbrs_h.shape[1]), -1, np.int32)])
            if self._boot_nbrs is not None:
                self._boot_nbrs = np.concatenate([self._boot_nbrs, np.full(
                    (pad, self._boot_nbrs.shape[1]), -1, np.int32)])

    def _auto_nlist(self, n_live: int) -> int:
        if self._nlist_cfg > 0:
            return max(1, self._nlist_cfg)
        if n_live <= 64:
            return 1
        return self._shape_bucket(int(min(
            MAX_AUTO_NLIST, max(2, round(math.sqrt(n_live))))))

    @staticmethod
    def _shape_bucket(v: int, align: int = 8) -> int:
        """Round up to a ~12.5%-granularity rung (power-of-two-scaled
        multiples, min `align`). Kept from the reference so C and L —
        and with them the layout and the candidate pool — match it."""
        if v <= align:
            return align
        g = max(align, 1 << max(0, v.bit_length() - 4))
        return ((v + g - 1) // g) * g

    def _nprobe(self, c: int) -> int:
        if self._nprobe_cfg > 0:
            return min(c, self._nprobe_cfg)
        if self._nprobe_tuned > 0:            # ivf_target_recall
            return min(c, self._nprobe_tuned)
        # c/8 (>= 8): the recall band the reference measured for c/8
        return min(c, max(8, c // 8))

    # ------------------------------------------------------------- build
    def _build_ivf(self) -> None:
        """Full (re)build: train centroids on the device, pack every live
        row into a cluster slot, upload the block layout. Runs under the
        corpus lock (callers: sync)."""
        rows = np.where(self._live_h)[0].astype(np.int32)
        n = len(rows)
        if n == 0:
            self._ivf_dev = None
            self._centroids_h = None
            self._cluster_of[:] = -1
            self._slot_of[:] = -1
            self._cluster_of2[:] = -1
            self._slot_of2[:] = -1
            self._cluster_free = []
            self._trained_live = 0
            self._has_spill = False
            self._nbrs_h = None
            self._graph_seq += 1              # discard in-flight builds
            self._graph_inflight = False
            self._publish_info()
            return
        dev = self._device
        data = self._emb_h[rows]              # unit-norm fp32 [N, d]
        boot_cent, boot_cluster = self._boot_cent, self._boot_cluster
        boot_cluster2 = self._boot_cluster2
        self._boot_cent = None
        self._boot_cluster = None
        self._boot_cluster2 = None
        if (boot_cent is not None and boot_cluster is not None
                and boot_cent.ndim == 2
                and boot_cent.shape[1] == self.dim):
            c = boot_cent.shape[0]
            cent = np.ascontiguousarray(boot_cent, np.float32)
            # rows without a hint (mutated since the load) assign now
            first = np.full(n, -1, np.int32)
            inb = rows < len(boot_cluster)
            first[inb] = boot_cluster[rows[inb]]
            miss = (first < 0) | (first >= c)
            if miss.any():
                cent_dev = torch.from_numpy(cent).to(dev)
                mrows = np.where(miss)[0]
                for s in range(0, len(mrows), ASSIGN_CHUNK):
                    sel = mrows[s:s + ASSIGN_CHUNK]
                    a1, _, _, _ = assign_top2(
                        torch.from_numpy(data[sel]).to(dev), cent_dev)
                    first[sel] = a1.cpu().numpy()
            second = None                     # spill: hints only
            margin = None
            boot_restored = True
        else:
            boot_restored = False
            c = self._auto_nlist(n)
            rng = np.random.default_rng(n)    # deterministic per size
            sample = data[rng.choice(n, size=min(n, 131072),
                                     replace=False)]
            init = sample[rng.choice(len(sample), size=c,
                                     replace=len(sample) < c)]
            cent_dev = kmeans(torch.from_numpy(sample).to(dev),
                              torch.from_numpy(init).to(dev), iters=8)
            cent = cent_dev.cpu().numpy()
            # assign every live row: best-2 clusters, chunked matmul
            first = np.empty(n, np.int32)
            second = np.empty(n, np.int32)
            margin = np.empty(n, np.float32)  # spill priority
            for s in range(0, n, ASSIGN_CHUNK):
                a1, a2, v1, v2 = assign_top2(
                    torch.from_numpy(data[s:s + ASSIGN_CHUNK]).to(dev),
                    cent_dev)
                first[s:s + ASSIGN_CHUNK] = a1.cpu().numpy()
                second[s:s + ASSIGN_CHUNK] = a2.cpu().numpy()
                margin[s:s + ASSIGN_CHUNK] = (v1 - v2).cpu().numpy()
        # capped packing: first choice vectorized (rank within cluster by
        # one stable argsort); the overflow (k-means imbalance) falls back
        # to the second choice, then to any cluster with room
        lcap = self._shape_bucket(
            max(8, int(math.ceil(n / c * SLOT_SLACK))))
        cluster = np.empty(n, np.int32)
        slot = np.empty(n, np.int32)
        order = np.argsort(first, kind="stable")
        fs = first[order]
        starts = np.searchsorted(fs, np.arange(c))
        rank = (np.arange(n) - starts[fs]).astype(np.int32)
        ok = rank < lcap
        cluster[order[ok]] = fs[ok]
        slot[order[ok]] = rank[ok]
        fill = np.bincount(fs[ok], minlength=c).astype(np.int32)
        for j in order[~ok]:
            ch = int(second[j]) if second is not None else -1
            if ch < 0 or fill[ch] >= lcap:
                ch = int(np.argmin(fill))     # any cluster with room
            cluster[j] = ch
            slot[j] = fill[ch]
            fill[ch] += 1
        # centered int8 quantization
        mu = data.mean(axis=0).astype(np.float32)
        qv, rinv, self._quant_mu = quantize_rows_centered(data, mu)
        emb_i8 = np.zeros((c, lcap, self.dim), np.int8)
        rinv_sl = np.zeros((c, lcap), np.float32)
        slot_rows = np.full((c, lcap), -1, np.int32)
        kind_sl = np.full((c, lcap), PAD_CODE, np.int32)
        agent_sl = np.full((c, lcap), PAD_CODE, np.int32)
        emb_i8[cluster, slot] = qv
        rinv_sl[cluster, slot] = rinv
        slot_rows[cluster, slot] = rows
        kind_sl[cluster, slot] = self._kind_h[rows]
        agent_sl[cluster, slot] = self._agent_h[rows]
        self._cluster_of[:] = -1
        self._slot_of[:] = -1
        self._cluster_of[rows] = cluster
        self._slot_of[rows] = slot
        # spill packing: duplicate boundary rows (smallest first-vs-second
        # centroid margin) into their second-choice cluster's free slots,
        # keeping max(room//4, 1) slots per cluster for inserts
        self._cluster_of2[:] = -1
        self._slot_of2[:] = -1
        if self._spill > 0 and c > 1:
            if second is not None:
                sec_c, prio = second, margin
            elif boot_cluster2 is not None and len(boot_cluster2):
                sec_c = np.full(n, -1, np.int32)
                inb2 = rows < len(boot_cluster2)
                sec_c[inb2] = boot_cluster2[rows[inb2]]
                prio = np.zeros(n, np.float32)  # hint set, no margins
            else:
                sec_c = None
            if sec_c is not None:
                elig = np.where((sec_c >= 0) & (sec_c < c)
                                & (sec_c != cluster))[0]
                if len(elig):
                    room = lcap - fill
                    avail = np.floor(
                        np.maximum(0, room - np.maximum(room // 4, 1))
                        * self._spill).astype(np.int64)
                    sec = sec_c[elig]
                    o = np.lexsort((prio[elig], sec))
                    secs = sec[o]
                    st2 = np.searchsorted(secs, np.arange(c))
                    rank2 = np.arange(len(o)) - st2[secs]
                    ok2 = rank2 < avail[secs]
                    sel = elig[o[ok2]]
                    sc = secs[ok2].astype(np.int32)
                    ss = (fill[sc] + rank2[ok2]).astype(np.int32)
                    emb_i8[sc, ss] = qv[sel]
                    rinv_sl[sc, ss] = rinv[sel]
                    slot_rows[sc, ss] = rows[sel]
                    kind_sl[sc, ss] = self._kind_h[rows[sel]]
                    agent_sl[sc, ss] = self._agent_h[rows[sel]]
                    self._cluster_of2[rows[sel]] = sc
                    self._slot_of2[rows[sel]] = ss
        free_mask = slot_rows < 0
        self._cluster_free = [list(np.where(free_mask[ci])[0][::-1])
                              for ci in range(c)]
        self._centroids_h = cent
        self._slot_cap = lcap
        self._trained_live = n
        # device copies (a clone on the CPU too): a background graph build
        # reads the host arrays while _apply_dirty writes the device planes
        self._ivf_dev = tuple(self._to_dev(a) for a in (
            cent, emb_i8, rinv_sl, slot_rows, kind_sl, agent_sl))
        self._has_spill = bool((self._cluster_of2[rows] >= 0).any())
        # recall-target tuning: a carried-over pick is consumed once (the
        # layout is the one it was measured on); a fresh train re-measures
        boot_np, boot_curve = self._boot_nprobe_tuned, self._boot_tune_curve
        boot_boost, boot_delivered = (self._boot_cand_boost,
                                      self._boot_delivered)
        self._boot_nprobe_tuned = 0
        self._boot_tune_curve = None
        self._boot_cand_boost = 0
        self._boot_delivered = None
        if self._target_recall <= 0.0 or self._nprobe_cfg > 0:
            self._nprobe_tuned = 0            # explicit nprobe wins
            self._tune_curve = []
        elif boot_restored and boot_np > 0:
            self._nprobe_tuned = min(c, boot_np)
            self._tune_curve = list(boot_curve or [])
            if boot_boost > 0:
                self._cand_boost = boot_boost
            self._delivered_recall = boot_delivered
        else:
            self._tune_nprobe(rows, data, c, *self._ivf_dev[1:4])
        # the kNN graph: a carried-over one as it is (one-shot, like the
        # clustering hints); else built inline below WARM_MIN_SLOTS from
        # the device planes, or on a background thread from the host ones
        boot_nbrs, self._boot_nbrs = self._boot_nbrs, None
        self._graph_seq += 1                  # invalidate in-flight builds
        self._graph_inflight = False
        self._graph_error = None
        self._nbrs_h = None
        if boot_nbrs is not None and self._graph_degree > 0:
            self._nbrs_h = boot_nbrs
        elif self._graph_degree > 0 and lcap > 1:
            if c * lcap < WARM_MIN_SLOTS:
                t0 = time.monotonic()
                stats = {}
                self._nbrs_h = knn_graph.build_knn_graph(
                    *self._ivf_dev[1:4], self._quant_mu,
                    degree=self._graph_degree, cap=self._cap, rows=rows,
                    cluster_of=self._cluster_of, slot_of=self._slot_of,
                    cluster_of2=self._cluster_of2, slot_of2=self._slot_of2,
                    stats=stats)
                self._graph_stats = dict(stats, background=False,
                                         wall_s=time.monotonic() - t0)
            else:
                self._spawn_graph_build(emb_i8, rinv_sl, slot_rows, rows)
        self._publish_info()

    def _publish_info(self) -> None:
        """Publish the state index_info() serves as one dict, swapped
        whole: a reader never waits on the corpus lock for a retrain and
        never sees a mix of two builds."""
        if self._centroids_h is None:
            self._info_pub = {"trained": False}
            return
        c = int(self._centroids_h.shape[0])
        self._info_pub = {
            "trained": True,
            "nlist": c,
            "nprobe": int(self._nprobe(c)),
            "nprobe_tuned": int(self._nprobe_tuned),
            "target_recall": float(self._target_recall),
            "tune_curve": [[int(p), round(float(r), 4)]
                           for p, r in self._tune_curve],
            "delivered_recall": (round(float(self._delivered_recall), 4)
                                 if self._delivered_recall is not None
                                 else None),
            "cand_boost": int(self._cand_boost),
            "graph_degree": int(self._graph_degree),
            # whether refinement serves: False while a background build
            # runs, after one failed (graph_error says why) or at degree 0
            "graph_built": self._nbrs_h is not None,
            "graph_error": self._graph_error,
            "spill": bool(self._has_spill),
        }

    def _tune_nprobe(self, rows: np.ndarray, data: np.ndarray, c: int,
                     emb_i8: torch.Tensor, rinv_sl: torch.Tensor,
                     slot_rows: torch.Tensor) -> None:
        """Measure the probe-hit curve on the corpus itself and serve the
        smallest ladder nprobe whose sampled recall@10 meets the target
        (the reference's _tune_nprobe, step for step).

        Sampled rows are self-queries; their true top-10 is by the
        layout's own int8 scores (what the candidate scan could at best
        find at full probe): K1 over chunks of the flattened [C * L, d]
        layout, dead slots biased to NEG_INF, top-k_chunk each, merged on
        the host. Clusters rank per query as the search ranks them (fp32
        q . centroids); a truth row is hit at p when its home or spill
        cluster ranks inside the top p. Then the delivered recall through
        the real search, and a wider candidate list (x2, up to x4) while
        it misses the target and widening helps. Runs under the lock."""
        self._nprobe_tuned = 0
        self._tune_curve = []     # never report a stale layout's curve
        self._cand_boost = 1      # re-measured per layout
        self._delivered_recall = None
        n = len(rows)
        if c <= 8 or n < 4 * TUNE_TRUTH_K:
            return                            # trivial layouts: auto
        rng = np.random.default_rng(n ^ 0x5EED)
        s = min(TUNE_SAMPLES, n)
        pick = rng.choice(n, size=s, replace=False)
        q = np.ascontiguousarray(data[pick], np.float32)    # [S, d]
        qrows = rows[pick]
        # the chunk bounds the int8 chunk (L * d bytes a cluster) and the
        # [S, cc * L] f32 scores (4 S a slot); the last chunk slides back
        # and overlaps, and the host merge drops its duplicates
        lcap = int(emb_i8.shape[1])
        per_cluster = lcap * (self.dim + 4 * s)
        cc = max(1, min(c, GATHER_BUDGET_BYTES // max(1, per_cluster)))
        k_chunk = min(cc * lcap, 2 * TUNE_TRUTH_K + 12)   # dup/self margin
        qi8, qs = quantize_queries(torch.from_numpy(q).to(emb_i8.device))
        vs, rs = [], []
        for c0 in range(0, c, cc):
            c0 = min(c0, c - cc)
            sr = slot_rows[c0:c0 + cc].reshape(-1)
            bias = torch.where(sr >= 0, 0.0, NEG_INF).to(torch.float32)
            v, i = quant_candidates(emb_i8[c0:c0 + cc].reshape(-1, self.dim),
                                    rinv_sl[c0:c0 + cc].reshape(-1), qi8, qs,
                                    bias, k_chunk)
            vs.append(v.cpu().numpy())
            rs.append(sr[i.long()].cpu().numpy())
        v = np.concatenate(vs, axis=1)        # [S, nchunk * k]
        r = np.concatenate(rs, axis=1)
        order = np.argsort(-v, axis=1, kind="stable")
        v = np.take_along_axis(v, order, axis=1)
        r = np.take_along_axis(r, order, axis=1)
        # per query: drop self and spill / overlap duplicates, keep top-10
        truth = np.full((s, TUNE_TRUTH_K), -1, np.int64)
        for qi in range(s):
            seen = {int(qrows[qi])}
            t = 0
            for j in range(r.shape[1]):
                if v[qi, j] <= NEG_INF / 2:
                    break
                row = int(r[qi, j])
                if row in seen:
                    continue
                seen.add(row)
                truth[qi, t] = row
                t += 1
                if t == TUNE_TRUTH_K:
                    break
        valid = truth >= 0
        total = int(valid.sum())
        if total == 0:
            return
        # the search's probe order: fp32 q . cent^T
        cs = q @ self._centroids_h.T          # [S, C]
        crank = np.empty((s, c), np.int64)
        np.put_along_axis(
            crank, np.argsort(-cs, axis=1, kind="stable"),
            np.broadcast_to(np.arange(c, dtype=np.int64), (s, c)), axis=1)
        tr = np.where(valid, truth, 0)
        cl1 = self._cluster_of[tr]
        cl2 = self._cluster_of2[tr]
        r1 = np.take_along_axis(crank, np.clip(cl1, 0, c - 1).astype(
            np.int64), axis=1)
        r1 = np.where(cl1 >= 0, r1, c)
        r2 = np.take_along_axis(crank, np.clip(cl2, 0, c - 1).astype(
            np.int64), axis=1)
        r2 = np.where(cl2 >= 0, r2, c)
        pr = np.sort(np.minimum(r1, r2)[valid])
        # rungs: C/64..C/2 by doubling, then 3C/4, then C
        ladder = sorted({max(8, c >> i) for i in range(6, 0, -1)}
                        | {(3 * c) // 4, c})
        curve = [(p, np.searchsorted(pr, p, side="left") / total)
                 for p in ladder if p <= c]
        chosen = c
        for p, rec in curve:
            if rec >= self._target_recall:
                chosen = p
                break
        self._nprobe_tuned = chosen
        self._tune_curve = [(int(p), float(rec)) for p, rec in curve]
        log.info("ivf nprobe tune: target %.3f -> nprobe %d/%d (auto would "
                 "be %d; sampled probe-hit curve %s)", self._target_recall,
                 chosen, c, max(8, c // 8),
                 [(p, round(float(rec), 4)) for p, rec in curve])
        # probe-hit only bounds the delivered recall from above: measure
        # it through the real search and widen the candidate list while it
        # misses the target and widening helps
        delivered = self._measure_delivered(q, qrows, truth, valid)
        while (delivered is not None
               and delivered < self._target_recall - 1e-9
               and self._cand_boost < 4):
            self._cand_boost *= 2
            re_meas = self._measure_delivered(q, qrows, truth, valid)
            log.info("ivf tune: delivered recall %.4f < target %.3f -> "
                     "cand width x%d (re-measured %s)", delivered,
                     self._target_recall, self._cand_boost, re_meas)
            if re_meas is None or re_meas <= delivered + 1e-9:
                self._cand_boost //= 2        # not candidate-bound
                break
            delivered = re_meas
        self._delivered_recall = delivered

    def _measure_delivered(self, q: np.ndarray, qrows: np.ndarray,
                           truth: np.ndarray,
                           valid: np.ndarray) -> Optional[float]:
        """Delivered recall@10 on the tuner's sample through the real
        search: _dispatch_search at the tuned nprobe and candidate width,
        then the exact fp32 re-rank on the host mirror, the query's own
        row excluded as in the truth. Named deviation from the reference
        (cortex_tpu/vector/ivf.py:1290-1292): a query's candidates are its
        valid entries (score > -1e29), and a query with none counts its
        truth rows as misses; the reference reads rows >= 0 (an invalid
        entry comes back as row 0) and skips a query with none, which
        lifts the reading. Returns None when the search fails; the tuner
        then keeps the probe-hit pick."""
        try:
            s = q.shape[0]
            ak, aa, ex, hb = self._filter_codes(None, None, None)
            _, kb = self._k_bucket(TUNE_TRUTH_K)
            v, rows, _ = self._dispatch_search(q, ak, aa, ex, kb,
                                               host_bias=hb)
            v_h, rows_h = v.cpu().numpy()[:s], rows.cpu().numpy()[:s]
            hits = total = 0
            for i in range(s):
                t = truth[i][valid[i]]
                total += len(t)
                cand = np.unique(rows_h[i][v_h[i] > -1e29])
                if cand.size == 0:
                    continue                  # every truth row missed
                sc = self._emb_h[cand] @ q[i]
                sc = np.where(cand == int(qrows[i]), -np.inf, sc)
                top = set(cand[np.argsort(-sc)[:TUNE_TRUTH_K]].tolist())
                hits += sum(1 for r_ in t if int(r_) in top)
            return hits / total if total else None
        except Exception:  # noqa: BLE001 — keep the probe-hit pick
            log.warning("ivf tune: delivered-recall measurement failed; "
                        "keeping the probe-hit pick", exc_info=True)
            return None

    def _spawn_graph_build(self, emb_i8: np.ndarray, rinv_sl: np.ndarray,
                           slot_rows: np.ndarray, rows: np.ndarray) -> None:
        """Build the kNN graph off the lock on a background thread, for
        serving-scale layouts. It reads the host planes _build_ivf made
        (the device planes take in-place writes from _apply_dirty; these
        arrays nothing writes again) and copies of the per-row placement
        maps, uploads them a chunk at a time and runs N1 on a CUDA stream
        of its own, so searches do not queue behind it. The table is
        swapped in under the lock unless a rebuild superseded it (seq
        check); rows mutated meanwhile lose their out-edges at the swap.
        A build that fails is logged with its error and leaves the graph
        off until the next rebuild: refinement only adds recall.
        index_info() publishes the swap (graph_built) or the error
        (graph_error). Callers hold the corpus lock."""
        seq = self._graph_seq
        self._graph_inflight = True
        self._graph_stale = set()
        mu, cap, deg, dev = (self._quant_mu, self._cap, self._graph_degree,
                             self._device)
        maps = dict(cluster_of=self._cluster_of.copy(),
                    slot_of=self._slot_of.copy(),
                    cluster_of2=self._cluster_of2.copy(),
                    slot_of2=self._slot_of2.copy())

        def build(stats):
            return knn_graph.build_knn_graph(
                emb_i8, rinv_sl, slot_rows, mu, degree=deg, cap=cap,
                rows=rows, device=dev, stats=stats, **maps)

        def run():
            t0 = time.monotonic()
            stats: dict = {}
            error = None
            try:
                if dev.type == "cuda":
                    with torch.cuda.device(dev), torch.cuda.stream(
                            torch.cuda.Stream(dev)):
                        out = build(stats)
                else:
                    out = build(stats)
            except Exception as e:  # noqa: BLE001 — logged and published
                log.exception("background knn-graph build failed; the "
                              "graph stays off until the next rebuild")
                out, error = None, f"{type(e).__name__}: {e}"
            with self._lock:
                if seq != self._graph_seq:
                    return                    # superseded: discard
                self._graph_inflight = False
                if out is None:
                    self._graph_error = error
                    self._publish_info()
                    return
                for r in self._graph_stale:
                    if 0 <= r < len(out):
                        out[r] = -1
                if len(out) < self._cap:      # the corpus grew meanwhile
                    out = np.concatenate([out, np.full(
                        (self._cap - len(out), out.shape[1]), -1, np.int32)])
                self._nbrs_h = out
                self._graph_stats = dict(stats, background=True,
                                         wall_s=time.monotonic() - t0)
                self._publish_info()
                log.info("knn graph swapped in (background build, %d stale "
                         "rows masked)", len(self._graph_stale))

        self._graph_thread = threading.Thread(target=run, daemon=True,
                                              name="ivf-graph-build")
        self._graph_thread.start()

    def release(self) -> None:
        """DeviceCorpus.release, and the background graph build: its
        table is discarded (seq bump) and its thread joined, so nothing
        of this corpus outlives the call on the device or writes after
        it."""
        with self._lock:
            self._graph_seq += 1
            self._graph_inflight = False
            self._ivf_dev = None
            thread, self._graph_thread = self._graph_thread, None
            super().release()
        if thread is not None:
            thread.join()

    def _grow_slots(self) -> bool:
        """Extend the slot axis to the next shape rung on the device when
        incremental placement runs out of room (cluster assignments
        kept). Returns False when no layout exists or the rung can't
        grow; the caller then rebuilds. Callers hold the corpus lock."""
        if self._ivf_dev is None or self._slot_cap <= 0:
            return False
        cent, emb_i8, rinv_sl, slot_rows, kind_sl, agent_sl = self._ivf_dev
        c = emb_i8.shape[0]
        l = self._slot_cap
        l2 = self._shape_bucket(l + 1)
        pad = l2 - l
        if pad <= 0:
            return False

        def grown(a, value):
            return torch.cat([a, torch.full((c, pad) + a.shape[2:], value,
                                            dtype=a.dtype,
                                            device=a.device)], dim=1)

        self._ivf_dev = (cent, grown(emb_i8, 0), grown(rinv_sl, 0.0),
                         grown(slot_rows, -1), grown(kind_sl, PAD_CODE),
                         grown(agent_sl, PAD_CODE))
        for f in self._cluster_free:
            f.extend(range(l, l2))
        self._slot_cap = l2
        return True

    def _apply_dirty(self, rows: np.ndarray) -> bool:
        """Incremental slot maintenance for dirty rows. Returns False
        when placement ran out of room (caller rebuilds).

        Writes are keyed by (cluster, slot), LAST WINS: a slot vacated by
        one row can be taken by a later row of the same batch, so
        duplicates are resolved on the host before the one in-place
        device write."""
        writes: dict = {}                     # (c, s) -> global row | -1
        live_rows = rows[self._live_h[rows]]
        pref = None
        if len(live_rows):
            sc = self._emb_h[live_rows] @ self._centroids_h.T
            take = min(8, sc.shape[1])
            pref = np.argsort(-sc, axis=1)[:, :take]
        li = 0
        for r in rows:
            # a dirty row's SPILL copy is always dropped (a delete must
            # not leave a live duplicate, an update's stale copy would
            # score the old vector); spill copies are made at build time
            cl2, sl2 = int(self._cluster_of2[r]), int(self._slot_of2[r])
            if sl2 >= 0:
                writes[(cl2, sl2)] = -1
                self._cluster_free[cl2].append(sl2)
                self._cluster_of2[r] = -1
                self._slot_of2[r] = -1
            cl, sl = int(self._cluster_of[r]), int(self._slot_of[r])
            if not self._live_h[r]:
                if sl >= 0:                   # clear the vacated slot
                    writes[(cl, sl)] = -1
                    self._cluster_free[cl].append(sl)
                    self._cluster_of[r] = -1
                    self._slot_of[r] = -1
                continue
            choices = pref[li]
            li += 1
            best = int(choices[0])
            if cl == best and sl >= 0:
                target_c, target_s = cl, sl   # in-place value update
            else:
                target_c = -1
                for ch in choices:            # nearest with room
                    if self._cluster_free[int(ch)]:
                        target_c = int(ch)
                        break
                if target_c < 0:              # any room at all?
                    for ch, f in enumerate(self._cluster_free):
                        if f:
                            target_c = ch
                            break
                if target_c < 0:
                    # every slot taken: grow the slot axis, then rebuild
                    # only if that fails
                    if not self._grow_slots():
                        return False
                    target_c = best
                target_s = self._cluster_free[target_c].pop()
                if sl >= 0:                   # vacate the old slot
                    writes[(cl, sl)] = -1
                    self._cluster_free[cl].append(sl)
                self._cluster_of[r] = target_c
                self._slot_of[r] = target_s
            writes[(target_c, target_s)] = int(r)
        if not writes:
            return True
        c_idx = np.fromiter((c for c, _ in writes), np.int64)
        s_idx = np.fromiter((s for _, s in writes), np.int64)
        sr = np.fromiter(writes.values(), np.int32)
        dead = sr < 0
        src = np.where(dead, 0, sr)           # dead slots: value ignored
        qv, ri, _ = quantize_rows_centered(self._emb_h[src],
                                           self._quant_mu)
        ri = np.where(dead, 0.0, ri).astype(np.float32)
        qv[dead] = 0
        kc = np.where(dead, PAD_CODE, self._kind_h[src]).astype(np.int32)
        ac = np.where(dead, PAD_CODE, self._agent_h[src]).astype(np.int32)
        dev = self._device
        idx = (torch.from_numpy(c_idx).to(dev),
               torch.from_numpy(s_idx).to(dev))
        _, emb_i8, rinv_sl, slot_rows, kind_sl, agent_sl = self._ivf_dev
        for plane, vals in ((emb_i8, qv), (rinv_sl, ri), (slot_rows, sr),
                            (kind_sl, kc), (agent_sl, ac)):
            plane.index_put_(idx, torch.from_numpy(vals).to(dev))
        return True

    def sync(self) -> None:
        """Push host diffs into the block layout; full rebuild (with
        retrain) when the structure is stale, absent, or drifted."""
        with self._lock:
            self._check_live()
            if self._cap == 0:
                return
            n_live = int(self._live_h.sum())
            stale = (self._ivf_dev is None and n_live > 0)
            drifted = (self._trained_live > 0 and
                       (n_live > RETRAIN_GROWTH * self._trained_live
                        or n_live * RETRAIN_GROWTH < self._trained_live))
            bulk = len(self._dirty) > max(4096, self._cap // 8)
            if self._full_resync or stale or drifted or bulk:
                self._build_ivf()
                self._full_resync = False
                self._dirty.clear()
                return
            if not self._dirty:
                return
            rows = np.fromiter(self._dirty, np.int32)
            if not self._apply_dirty(rows):
                self._build_ivf()
            self._dirty.clear()

    # ------------------------------------------------------------- search
    def _expand_candidates(self, i, valid, q_np, flt):
        """Graph refinement: widen the fetched candidate list with the
        kNN-graph neighbours of its top REFINE_FRONTIER entries before the
        exact re-rank, so a true top-k row whose cluster ranks low is
        reached through a found neighbour's edge. Expanded rows are
        checked against the host mirrors (liveness, kind, agent,
        exclusions: the device never saw them) and deduplicated, the
        device's own candidate first; the exact re-rank then scores
        everything fp32-true, so refinement can only add recall.
        REFINE_HOPS >= 2 re-expands from the exact-scored top of each
        hop's additions. Runs under the corpus lock."""
        nbrs = self._nbrs_h
        if nbrs is None or REFINE_FRONTIER <= 0 or REFINE_HOPS <= 0:
            return i, valid
        kinds, agent, exclude_ids = flt if flt else (None, None, None)
        codes = acode = ex_rows = None
        if kinds is not None:
            codes = np.asarray([self.kinds.lookup(kk) for kk in kinds],
                               np.int32)
        if agent is not None:
            acode = self.agents.lookup(agent)
        if exclude_ids:
            ex_rows = np.asarray(
                [self._row_of[x] for x in exclude_ids
                 if x in self._row_of], np.int32)
        b = i.shape[0]
        e = min(REFINE_FRONTIER, i.shape[1])
        r = nbrs.shape[1]
        # the device's candidates arrive in descending int8 score
        front_i, front_v = i[:, :e], valid[:, :e]
        parts_i, parts_v = [i], [valid]
        for hop in range(REFINE_HOPS):
            ext = nbrs[np.where(front_v, front_i, 0)].reshape(b, -1)
            ok = np.repeat(front_v, r, axis=1) & (ext >= 0)
            ext = np.where(ok, ext, 0)
            ok &= self._live_h[ext]
            if codes is not None:
                ok &= np.isin(self._kind_h[ext], codes)
            if acode is not None:
                ok &= self._agent_h[ext] == acode
            if ex_rows is not None and len(ex_rows):
                ok &= ~np.isin(ext, ex_rows)
            parts_i.append(ext)
            parts_v.append(ok)
            if hop + 1 < REFINE_HOPS:
                # next frontier: the exact top-e of this hop's additions
                g = self._emb_h[ext.reshape(-1)].reshape(b, -1, self.dim)
                sc = np.matmul(g, q_np[:, :, None])[:, :, 0]
                sc = np.where(ok, sc, NEG_INF)
                sel = np.argsort(-sc, axis=1)[:, :e]
                front_i = np.take_along_axis(ext, sel, axis=1)
                front_v = (np.take_along_axis(ok, sel, axis=1)
                           & (np.take_along_axis(sc, sel, axis=1) > -1e29))
        i2 = np.concatenate(parts_i, axis=1)
        v2 = np.concatenate(parts_v, axis=1)
        return i2, knn_graph.dedup_keep_first(i2, v2)

    def _dispatch_search(self, q_np: np.ndarray, ak, aa, ex, k_bucket: int,
                         host_bias: Optional[np.ndarray] = None):
        """Enqueue the IVF search; returns (values, GLOBAL rows, True) so
        the inherited _finish_topk re-ranks the candidates exactly
        against the fp32 host mirror. Callers hold the corpus lock."""
        dev = self._device
        b = q_np.shape[0]
        if self._ivf_dev is None:             # empty corpus
            return (torch.full((b, k_bucket), NEG_INF, dtype=torch.float32),
                    torch.zeros((b, k_bucket), dtype=torch.int32), False)
        c = self._ivf_dev[0].shape[0]
        p = self._nprobe(c)
        cand = min(self._cand_count(k_bucket) * self._cand_boost,
                   p * self._slot_cap)
        q = torch.from_numpy(q_np).to(dev)
        hb = None
        if host_bias is not None:
            hb = torch.from_numpy(host_bias).to(dev)
            ak = np.full(MAX_FILTER_KINDS, NO_FILTER, np.int32)
            aa = np.int32(NO_FILTER)
            ex = np.full(MAX_EXCLUDE, NO_FILTER, np.int32)
            filtered = False
        else:
            filtered = bool(ak[0] != NO_FILTER or aa != NO_FILTER
                            or ex[0] != NO_FILTER)
        ak_t = torch.from_numpy(np.asarray(ak, np.int32)).to(dev)
        aa_t = torch.from_numpy(np.asarray([aa], np.int32)).to(dev)
        ex_t = torch.from_numpy(np.asarray(ex, np.int32)).to(dev)
        v, rows = ivf_search(self._ivf_dev, q, ak_t, aa_t, ex_t, p=p,
                             cand=cand, filtered=filtered,
                             dedup=self._has_spill, host_bias=hb)
        if v.shape[1] < k_bucket:
            # tiny probed pool (nprobe*L < k bucket): pad so the re-rank
            # still sees at least kk candidate columns
            pad = k_bucket - v.shape[1]
            v = torch.nn.functional.pad(v, (0, pad), value=NEG_INF)
            rows = torch.nn.functional.pad(rows, (0, pad))
        return v, rows, True


class TorchIvfIndex(TorchFlatIndex):
    """VectorIndex over IvfCorpus, selected with [embedding] index =
    "ivf". `device` is "cuda" (the default; raises when CUDA is absent),
    "cpu", or a torch.device. retrain() forces a full k-means rebuild."""

    def __init__(self, dim: int, *, nlist: int = 0, nprobe: int = 0,
                 spill: float = 1.0, graph_degree: int = 32,
                 target_recall: float = 0.0, device="cuda"):
        self.dim = dim
        self._corpus = IvfCorpus(dim, nlist=nlist, nprobe=nprobe,
                                 spill=spill, graph_degree=graph_degree,
                                 target_recall=target_recall,
                                 device=resolve_device(device))

    def retrain(self) -> None:
        co = self._corpus
        with co._lock:
            co._full_resync = True
            co._boot_cent = None              # force a real k-means
            co._boot_cluster = None
            co._boot_cluster2 = None
            co._boot_nbrs = None              # and a fresh graph
            co.sync()

    def index_info(self) -> dict:
        """The index's published state (_publish_info), read without the
        corpus lock: a reader never queues behind a retrain, and gets the
        whole state of one build."""
        co = self._corpus
        info = {"kind": "ivf", "size": len(co._row_of),
                "capacity": int(co._cap), "device": str(co._device)}
        info.update(co._info_pub)
        return info
