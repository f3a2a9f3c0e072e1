"""IVF (inverted-file) index of the port: the sublinear search option.

Counterpart of cortex_tpu/vector/ivf.py (IvfCorpus, TpuIvfIndex):

  * build: spherical k-means on the device gives C centroids; every live
    row is packed into a slot of a padded [C, L, d] int8 block layout
    (centered quantization, ranking-invariant), with per-slot [C, L]
    planes: rinv (f32), slot_rows, kind_sl, agent_sl (int32). Boundary
    rows are spilled into their second-choice cluster's spare slots.
    The packing, spill and quantization are the reference's numpy code,
    so the same clustering gives the same layout slot for slot.
  * search: q @ centroids.T, top-nprobe clusters per query, the
    probed-block scan (ops/ivf_gather.py::probed_scores, a CUDA kernel
    on the card), top-`cand`, the query descale, spill dedup. The
    candidates then get the exact fp32 host re-rank of
    DeviceCorpus._finish_topk, so final scores are fp32-true and the
    only approximation is candidate membership.

Left out of this slice (ROADMAP queue A, 'IVF remainder'): the
recall-target nprobe tuner, the kNN-graph refinement, snapshots and the
warm-ahead compiles. Incremental updates write the layout in place
(index_put_ / torch.cat) under the corpus lock.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops.ivf_gather import probed_scores
from ..ops.similarity import (NEG_INF, quantize_queries,
                              quantize_rows_centered)
from ..utils.device import resolve_device
from .index import TorchFlatIndex, VectorIndex
from .shard import (DeviceCorpus, MAX_EXCLUDE, MAX_FILTER_KINDS,
                    NO_FILTER, PAD_CODE)

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
                 spill: float = 1.0, device):
        super().__init__(dim, device=device)
        self._nlist_cfg = int(nlist)          # 0 = auto (~sqrt(N))
        self._nprobe_cfg = int(nprobe)        # 0 = auto (C/8, >= 8)
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
        all numpy) the way TpuIvfIndex.load does: rows in `ids` order,
        then the clustering as one-shot hints for the next build. Loaded
        into an empty corpus, the build then packs the same [C, L, d]
        layout, slot for slot, as cortex_tpu's index loaded from the same
        state."""
        super().load_jax_state(st)
        ids = [str(i) for i in st["ids"]]
        cl = np.asarray(st["ivf_cluster"], np.int32)
        cl2 = np.asarray(st.get("ivf_cluster2",
                                np.full(len(cl), -1, np.int32)), np.int32)
        with self._lock:
            boot = np.full(self._cap, -1, np.int32)
            boot2 = np.full(self._cap, -1, np.int32)
            for j, nid in enumerate(ids):
                r = self._row_of[nid]
                boot[r] = cl[j]
                boot2[r] = cl2[j]
            self._boot_cent = np.asarray(st["ivf_centroids"], np.float32)
            self._boot_cluster = boot
            self._boot_cluster2 = boot2

    # -------------------------------------------------------- bookkeeping
    def _mask_boot_hint(self, row: int) -> None:
        """Drop the carried-over cluster hint of a mutated row: its
        vector (or its node) changed, so it re-assigns fresh at the next
        build. Callers hold the corpus lock."""
        for bc in (self._boot_cluster, self._boot_cluster2):
            if bc is not None and 0 <= row < len(bc):
                bc[row] = -1

    def upsert_batch(self, ids, vectors, kinds, agents) -> None:
        with self._lock:
            super().upsert_batch(ids, vectors, kinds, agents)
            if self._boot_cluster is not None:
                for nid in ids:
                    self._mask_boot_hint(self._row_of[nid])

    def remove(self, node_id: str) -> bool:
        with self._lock:
            row = self._row_of.get(node_id)
            out = super().remove(node_id)
            if out:
                self._mask_boot_hint(row)
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
        else:
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
        self._ivf_dev = tuple(torch.from_numpy(a).to(dev) for a in (
            cent, emb_i8, rinv_sl, slot_rows, kind_sl, agent_sl))
        self._has_spill = bool((self._cluster_of2[rows] >= 0).any())

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
        cand = min(self._cand_count(k_bucket), p * self._slot_cap)
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
    "cpu", or a torch.device."""

    def __init__(self, dim: int, *, nlist: int = 0, nprobe: int = 0,
                 spill: float = 1.0, device="cuda"):
        self.dim = dim
        self._corpus = IvfCorpus(dim, nlist=nlist, nprobe=nprobe,
                                 spill=spill, device=resolve_device(device))

    # the flat index's description does not fit; the IVF's own (clustering
    # and nprobe state) is not ported yet (ROADMAP queue A, IVF remainder)
    index_info = VectorIndex.index_info
