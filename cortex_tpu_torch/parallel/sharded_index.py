"""ShardedFlatIndex: the flat index over a device mesh.

Counterpart of cortex_tpu/parallel/sharded_index.py. The same
`VectorIndex` surface as TorchFlatIndex; the corpus lives split along
the row axis over a `Mesh` (parallel/sharding.py): shard s of replica
group r keeps rows s * cap / S .. (s + 1) * cap / S of every plane on
device (r, s). A search runs per shard on its device (the filter's
bias on its rows; the product or the int8 scan; a local top-k) and
merges the shards' candidates exactly on the lead device
(sharding.py::run_sharded, merge_topk): top-k is associative, so the
merge gives the single-device answer.

Routes (`_dispatch_search`), each given the resolved filter
(vector/shard.py::SearchFilter), whose `bias_on` builds a shard's bias
from the filter lists (exclusions by global row) or takes its rows of
an overflowing filter's exact host bias:

  * exact (`_sharded_filtered_topk`): the fp32 (or bf16) product + bias
    and torch.topk on each shard; the scores are final.
  * quant (`_sharded_quant_topk`): K1 (ops/similarity.py::
    quant_candidates) on each shard's centered int8 shadow, then the
    merge to the global top-cand, returned with needs_rescore, so
    DeviceCorpus._finish_topk re-ranks the merged candidates exactly
    against the fp32 host mirror, as the reference does (the
    single-device port re-ranks on the device with K2; K2 per shard
    would re-rank other candidates). The reference's over-fetch
    (max(512, 2 cand)) feeds approx_max_k; K1's top-cand is exact, so
    each shard asks for min(cand, shard rows) and the merged set is the
    global int8 top-cand.
  * approx resolves to exact (no sharded approx route, as in the
    reference).

Host bookkeeping (id <-> row maps, dirty tracking, interners, the
re-rank) is DeviceCorpus's. A sync scatters dirty rows into their
shards in place, or re-uploads every shard past the bulk rule
(DeviceCorpus._bulk_resync); capacity growth re-places the layout (a
full upload), and the ladder's 1.25x steps stay divisible by the shard
count (_row_alignment).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..errors import IndexError_
from ..ops.similarity import (cosine_topk_xla, quant_candidates,
                              quantize_queries, quantize_rows_centered)
from ..utils.tracing import timed
from ..vector.index import TorchFlatIndex
from ..vector.shard import MIN_CAP, DeviceCorpus, SearchFilter, to_device
from .sharding import (Mesh, build_mesh, pad_batch, place_rows,
                       replica_count, run_sharded, shard_count,
                       unpad_rows)


def _sharded_filtered_topk(mesh: Mesh, planes, flt: SearchFilter, q, *,
                           k: int):
    """Per shard: the filter's bias on its rows (SearchFilter.bias_on),
    the product and its top-k; merged to the global top-k.
    planes[r][s] = (emb, live, kind_code, agent_code)."""
    shard_rows = planes[0][0][1].shape[0]

    def local(r, s, dev, qd):
        emb, live, kc, ac = planes[r][s]
        off = s * shard_rows
        v, i = cosine_topk_xla(emb, qd, min(k, shard_rows),
                               flt.bias_on(live, kc, ac, off))
        return v, i + off

    return run_sharded(mesh, q, local, k)


def _sharded_quant_topk(mesh: Mesh, planes, qplanes, flt: SearchFilter, q,
                        *, cand: int):
    """The int8 scan sharded: per shard the filter's bias and K1 to its
    top-cand (global rows), merged to the global top-cand for the host
    re-rank. qplanes[r][s] = (emb_i8, rinv)."""
    shard_rows = qplanes[0][0][1].shape[0]

    def local(r, s, dev, qd):
        _, live, kc, ac = planes[r][s]
        emb_i8, rinv = qplanes[r][s]
        off = s * shard_rows
        qi8, qs = quantize_queries(qd)
        v, i = quant_candidates(emb_i8, rinv, qi8, qs,
                                flt.bias_on(live, kc, ac, off),
                                min(cand, shard_rows))
        return v, i + off

    return run_sharded(mesh, q, local, cand)


class ShardedCorpus(DeviceCorpus):
    """DeviceCorpus whose device planes are split over a mesh's shard
    axis (a full copy per replica group), with the merged search.
    _dev / _dev_q hold [replica][shard] lists of plane tuples."""

    def __init__(self, dim: int, mesh: Optional[Mesh] = None,
                 storage_dtype: str = "float32",
                 search_path: str = "auto"):
        mesh = mesh or build_mesh()
        super().__init__(dim, device=mesh.lead, search_path=search_path,
                         storage_dtype=storage_dtype)
        self.mesh = mesh
        self._n_shard = shard_count(mesh)
        self._n_replica = replica_count(mesh)
        if MIN_CAP % self._n_shard != 0:
            raise IndexError_(
                f"mesh shard count {self._n_shard} must divide the "
                f"capacity ladder (powers of two from {MIN_CAP}); use a "
                f"power-of-two submesh, e.g. build_mesh("
                f"{1 << (self._n_shard.bit_length() - 1)})")

    def _row_alignment(self) -> int:
        # 1.25x gentle-growth steps strip the power-of-two factor; equal
        # shards need cap % n_shard == 0 at every rung
        return max(8, self._n_shard)

    def _can_grow_on_device(self) -> bool:
        return False          # growth re-places the layout: a full upload

    def _pad_batch(self, q_np):
        """Replica-axis batch padding (sharding.pad_batch)."""
        return pad_batch(self.mesh, q_np)

    _unpad_batch = staticmethod(unpad_rows)

    def _shard_rows(self) -> int:
        return self._cap // self._n_shard

    @timed("index.layout")
    def _upload_full(self, quant: bool) -> None:
        """Every plane to every shard, straight from the host mirror; the
        int8 shadow centered on the live mean, as on one device."""
        mu = None
        if quant or self._storage_dtype == torch.bfloat16:
            mu = self._live_mean()
        emb = self._emb_host(mu=mu)
        self._dev = place_rows(self.mesh, (emb, self._live_h, self._kind_h,
                                           self._agent_h),
                               self._shard_rows())
        if quant:
            q, rinv, self._quant_mu = quantize_rows_centered(
                self._emb_h, mu if mu is not None
                else np.zeros(self.dim, np.float32))
            self._dev_q = place_rows(self.mesh, (q, rinv),
                                     self._shard_rows())

    def _scatter(self, rows: np.ndarray, quant: bool) -> None:
        """Write dirty rows into their shards in place, in every replica
        group."""
        emb = self._emb_host(rows)
        vals = [emb, self._live_h[rows], self._kind_h[rows],
                self._agent_h[rows]]
        if quant:
            vals += quantize_rows_centered(self._emb_h[rows],
                                           self._quant_mu)[:2]
        sr = self._shard_rows()
        shard = rows // sr
        for s in np.unique(shard):
            sel = np.flatnonzero(shard == s)
            local = rows[sel] - s * sr
            for r, row in enumerate(self.mesh.grid()):
                dev = row[s]
                idx = to_device(local, dev)
                planes = self._dev[r][s] + (self._dev_q[r][s] if quant
                                            else ())
                for plane, v in zip(planes, vals):
                    plane.index_copy_(0, idx, to_device(v[sel], dev))

    def sync(self) -> None:
        with self._lock:
            self._check_live()
            if self._cap == 0:
                return
            quant = self._quant_enabled()
            if (self._dev is None or self._full_resync
                    or (quant and self._dev_q is None)
                    or self._bulk_resync()):
                self._upload_full(quant)
                self._full_resync = False
            elif self._dirty:
                self._scatter(np.fromiter(self._dirty, np.int64,
                                          len(self._dirty)), quant)
            self._dirty.clear()

    def _choose_path(self, k_bucket: int, emb_resident=None) -> str:
        path = super()._choose_path(k_bucket, emb_resident=True)
        # no sharded approx route; the exact merge is near its cost
        return "xla" if path == "approx" else path

    def _dispatch_search(self, q_np: np.ndarray, flt: SearchFilter,
                         k_bucket: int):
        """Enqueue the per-shard search and its merge (q_np is padded to
        the replica count by _dispatch). Returns (values, global rows,
        needs_rescore) on the lead device."""
        if self._choose_path(k_bucket) == "quant":
            v, i = _sharded_quant_topk(self.mesh, self._dev, self._dev_q, flt,
                                       q_np, cand=self._cand_count(k_bucket))
            return v, i, True
        v, i = _sharded_filtered_topk(self.mesh, self._dev, flt, q_np,
                                      k=k_bucket)
        return v, i, False


class ShardedFlatIndex(TorchFlatIndex):
    """Drop-in VectorIndex whose corpus spans the mesh ([embedding]
    sharded = true). With a 1-device mesh it serves as one device does,
    through the per-shard program and the merge."""

    def __init__(self, dim: int, mesh: Optional[Mesh] = None,
                 storage_dtype: str = "float32",
                 search_path: str = "auto"):
        self.dim = dim
        self._corpus = ShardedCorpus(dim, mesh, storage_dtype=storage_dtype,
                                     search_path=search_path)
        self._delta_ids: set = set()

    @property
    def mesh(self) -> Mesh:
        return self._corpus.mesh

    def _fresh_corpus(self) -> ShardedCorpus:
        return ShardedCorpus(self.dim, self._corpus.mesh,
                             storage_dtype=self._storage_dtype_str(),
                             search_path=self._corpus._search_path)
