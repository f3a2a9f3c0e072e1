"""ShardedIvfIndex: the IVF index over a device mesh.

Counterpart of cortex_tpu/parallel/sharded_ivf.py. The cluster axis is
the shard axis: shard s of each replica group owns lists s * C / S ..
(s + 1) * C / S of the [C, L, d] block layout on its device, so device
memory and the scan divide by the shard count. nlist is rounded to a
multiple of the shard count (_round_nlist).

Probing is per shard: each shard ranks its own centroids against the
query and probes its own top p_s = max(1, min(nprobe, C / S)) lists,
scans them with `probed_scores` (ops/ivf_gather.py, the port of the
reference's one Pallas kernel: csrc/ivf_gather.cu on the card, through
vector/ivf.py::ivf_search), and keeps its top-cand. The shards'
candidates are merged exactly on the lead device (sharding.py::
run_sharded), spill duplicates are masked after the merge (a spill copy
can sit on another shard than its primary), and the inherited graph
expansion and exact fp32 host re-rank finish the search. Probing the
full nprobe on every shard makes the probed set a superset of the
single-device probe set at equal nprobe (a list in the global top
nprobe has at most nprobe - 1 lists above it on its own shard), so
recall can only match or exceed the single-device layout. The
reference turns its Pallas kernel off here only because Mosaic is
single-device; its XLA path computes the same function as
probed_scores, which this port launches on every shard.

The resolved filter (vector/shard.py::SearchFilter) goes to every
device once a search (`lists_on`); slot_rows hold global rows, so
neither its exclusion list nor an overflowing filter's host bias
(replicated to every shard) is offset.
The kNN-graph build and the nprobe tuner read host copies of the
planes (_graph_build_arrays): N1 (block_knn) runs on chunks uploaded to
the lead device, and the tuner's truth is K1 there. Incremental writes
go to their list's shard in place (_write_slots); when a list runs out
of slots the layout is rebuilt (_grow_slots is off, as in the
reference).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.similarity import NEG_INF
from ..vector.ivf import IvfCorpus, TorchIvfIndex, dedup_rows, ivf_search
from ..vector.shard import SearchFilter, to_device
from .sharding import (Mesh, build_mesh, pad_batch, place_rows,
                       replica_count, run_sharded, shard_count,
                       unpad_rows)


def _sharded_ivf_topk(mesh: Mesh, layout, q, flt: SearchFilter, *,
                      p_s: int, cand: int, dedup: bool):
    """Per shard: probe its own lists, scan them, its top-cand; merged
    to the global top-cand on the lead device, spill duplicates masked
    after the merge. layout[r][s] = (cent, emb_i8, rinv_sl, slot_rows,
    kind_sl, agent_sl) of the shard's lists. Returns (values descaled,
    global rows, 0 where invalid)."""
    # the filter lists (and the host bias) on each distinct device before
    # any shard is enqueued (run_sharded's queries likewise)
    lists = {dev: flt.lists_on(dev) for dev in set(mesh.devices.flat)}

    def local(r, s, dev, qd):
        lay = layout[r][s]
        ak, aa, ex, hb = lists[dev]
        return ivf_search(lay, qd, ak, aa, ex, p=min(p_s, lay[0].shape[0]),
                          cand=cand, filtered=flt.filtered, dedup=False,
                          host_bias=hb)

    v, rows = run_sharded(mesh, q, local, cand)
    return dedup_rows(v, rows) if dedup else (v, rows)


class ShardedIvfCorpus(IvfCorpus):
    """IvfCorpus whose cluster axis spans the mesh. _ivf_dev holds a
    [replica][shard] list of layout tuples."""

    def __init__(self, dim: int, mesh: Optional[Mesh] = None, *,
                 nlist: int = 0, nprobe: int = 0, spill: float = 1.0,
                 graph_degree: int = 32, target_recall: float = 0.0):
        mesh = mesh or build_mesh()
        super().__init__(dim, nlist=nlist, nprobe=nprobe, spill=spill,
                         graph_degree=graph_degree,
                         target_recall=target_recall, device=mesh.lead)
        self.mesh = mesh
        self._n_shard = shard_count(mesh)
        self._n_replica = replica_count(mesh)

    def _pad_batch(self, q_np):
        return pad_batch(self.mesh, q_np)

    _unpad_batch = staticmethod(unpad_rows)

    def _round_nlist(self, c: int) -> int:
        # every shard owns the same number of lists
        return max(self._n_shard,
                   -(-c // self._n_shard) * self._n_shard)

    def _place_ivf(self, cent, emb_i8, rinv_sl, slot_rows, kind_sl,
                   agent_sl):
        # each shard's lists straight from the host arrays to its device:
        # no whole copy of the layout on the lead device
        return place_rows(self.mesh, (cent, emb_i8, rinv_sl, slot_rows,
                                      kind_sl, agent_sl),
                          cent.shape[0] // self._n_shard)

    def _graph_build_arrays(self, emb_i8, rinv_sl, slot_rows):
        # host copies: the graph build and the tuner upload chunks to the
        # lead device
        return emb_i8, rinv_sl, slot_rows

    def _grow_slots(self) -> bool:
        return False          # a full list re-places the layout

    def _write_slots(self, c_idx, s_idx, vals) -> None:
        per = self._centroids_h.shape[0] // self._n_shard
        shard = c_idx // per
        for s in np.unique(shard):
            sel = np.flatnonzero(shard == s)
            for r, row in enumerate(self.mesh.grid()):
                dev = row[s]
                idx = (to_device(c_idx[sel] - s * per, dev),
                       to_device(s_idx[sel], dev))
                for plane, v in zip(self._ivf_dev[r][s][1:], vals):
                    plane.index_put_(idx, to_device(v[sel], dev))

    def _dispatch_search(self, q_np: np.ndarray, flt: SearchFilter,
                         k_bucket: int):
        """Enqueue the per-shard probe + scan and the merge (q_np padded
        to the replica count); returns (values, GLOBAL rows, True) for
        the inherited expansion and exact host re-rank."""
        b = q_np.shape[0]
        if self._ivf_dev is None:             # empty corpus
            return (torch.full((b, k_bucket), NEG_INF, dtype=torch.float32),
                    torch.zeros((b, k_bucket), dtype=torch.int32), False)
        c = self._centroids_h.shape[0]
        # the full nprobe on every shard: a superset of the single-device
        # probe set (module docstring)
        p_s = max(1, min(self._nprobe(c), c // self._n_shard))
        cand = min(self._cand_count(k_bucket),
                   p_s * self._n_shard * self._slot_cap)
        v, rows = _sharded_ivf_topk(self.mesh, self._ivf_dev, q_np, flt,
                                    p_s=p_s, cand=cand,
                                    dedup=self._has_spill)
        if v.shape[1] < k_bucket:
            pad = k_bucket - v.shape[1]
            v = torch.nn.functional.pad(v, (0, pad), value=NEG_INF)
            rows = torch.nn.functional.pad(rows, (0, pad))
        return v, rows, True


class ShardedIvfIndex(TorchIvfIndex):
    """Drop-in VectorIndex: IVF over a device mesh ([embedding] index =
    "ivf" with sharded = true)."""

    def __init__(self, dim: int, mesh: Optional[Mesh] = None, *,
                 nlist: int = 0, nprobe: int = 0, spill: float = 1.0,
                 graph_degree: int = 32, target_recall: float = 0.0):
        self.dim = dim
        self._corpus = ShardedIvfCorpus(dim, mesh, nlist=nlist,
                                        nprobe=nprobe, spill=spill,
                                        graph_degree=graph_degree,
                                        target_recall=target_recall)
        self._delta_ids: set = set()

    @property
    def mesh(self) -> Mesh:
        return self._corpus.mesh

    def _fresh_corpus(self) -> ShardedIvfCorpus:
        old = self._corpus
        return ShardedIvfCorpus(self.dim, old.mesh, nlist=old._nlist_cfg,
                                nprobe=old._nprobe_cfg, spill=old._spill,
                                graph_degree=old._graph_degree,
                                target_recall=old._target_recall)
