"""Vector index interface of the port.

Counterpart of cortex_tpu/vector/index.py: `VectorFilter`, `SearchHit`
and the `VectorIndex` contract (insert / insert_batch / remove /
search / search_batch / search_threshold / len / contains /
index_info), plus `TorchFlatIndex`, the flat index over the device
corpus (vector/shard.py), whose corpus-backed methods `TorchIvfIndex`
(vector/ivf.py) inherits. Snapshots (save / load and the delta chain)
and compaction are not ported: an index is rebuilt from storage.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..errors import IndexError_
from ..utils.device import resolve_device
from .shard import DeviceCorpus

SearchHit = Tuple[str, float]          # (node_id, cosine score)


@dataclass
class VectorFilter:
    """Metadata constraints applied during search."""

    kinds: Optional[List[str]] = None
    source_agent: Optional[str] = None
    exclude_ids: List[str] = field(default_factory=list)


class VectorIndex:
    """Interface; see TorchIvfIndex."""

    dim: int

    def insert(self, node_id: str, vector: np.ndarray, *,
               kind: str = "", source_agent: str = "") -> None:
        raise NotImplementedError

    def insert_batch(self, ids: Sequence[str], vectors: np.ndarray, *,
                     kinds: Optional[Sequence[str]] = None,
                     agents: Optional[Sequence[str]] = None) -> None:
        kinds = kinds or [""] * len(ids)
        agents = agents or [""] * len(ids)
        for i, nid in enumerate(ids):
            self.insert(nid, vectors[i], kind=kinds[i], source_agent=agents[i])

    def remove(self, node_id: str) -> bool:
        raise NotImplementedError

    def search(self, vector: np.ndarray, k: int,
               flt: Optional[VectorFilter] = None, *,
               refine: bool = True) -> List[SearchHit]:
        return self.search_batch(np.asarray(vector)[None, :], k, flt,
                                 refine=refine)[0]

    def search_batch(self, vectors: np.ndarray, k: int,
                     flt: Optional[VectorFilter] = None, *,
                     refine: bool = True) -> List[List[SearchHit]]:
        """refine=False skips recall-widening candidate expansion
        (the IVF index's kNN-graph refinement); the linker's and dedup's
        bulk scans pass it. The flat index has nothing to expand."""
        raise NotImplementedError

    def search_threshold(self, vector: np.ndarray, threshold: float,
                         limit: int = 1000,
                         flt: Optional[VectorFilter] = None
                         ) -> List[SearchHit]:
        """All hits with score >= threshold (up to limit), best first."""
        hits = self.search(vector, min(limit, max(len(self), 1)), flt)
        return [(i, s) for i, s in hits if s >= threshold]

    def __len__(self) -> int:
        raise NotImplementedError

    def __contains__(self, node_id: str) -> bool:
        raise NotImplementedError

    def index_info(self) -> dict:
        """Operational description of the serving index."""
        return {"kind": type(self).__name__, "size": len(self)}

    def close(self) -> None:
        """Release what the index holds on its device (Cortex.reindex
        closes the index it replaces)."""


class TorchFlatIndex(VectorIndex):
    """The flat index, selected with [embedding] index = "flat" (the
    default): every search scans the whole device corpus. search_path
    is "auto", "exact", "approx" or "quant"; storage_dtype "float32" or
    "bfloat16"; `device` "cuda" (the default; raises when CUDA is
    absent), "cpu", or a torch.device."""

    def __init__(self, dim: int, *, search_path: str = "auto",
                 storage_dtype: str = "float32", device="cuda"):
        self.dim = dim
        self._corpus = DeviceCorpus(dim, device=resolve_device(device),
                                    search_path=search_path,
                                    storage_dtype=storage_dtype)

    def insert(self, node_id: str, vector: np.ndarray, *,
               kind: str = "", source_agent: str = "") -> None:
        self._corpus.upsert_batch(
            [node_id], np.asarray(vector, np.float32)[None, :],
            [kind], [source_agent])

    def insert_batch(self, ids: Sequence[str], vectors: np.ndarray, *,
                     kinds: Optional[Sequence[str]] = None,
                     agents: Optional[Sequence[str]] = None) -> None:
        if len(ids) == 0:
            return
        self._corpus.upsert_batch(
            ids, np.asarray(vectors, np.float32),
            list(kinds) if kinds else [""] * len(ids),
            list(agents) if agents else [""] * len(ids))

    def remove(self, node_id: str) -> bool:
        return self._corpus.remove(node_id)

    def search_batch(self, vectors: np.ndarray, k: int,
                     flt: Optional[VectorFilter] = None, *,
                     refine: bool = True) -> List[List[SearchHit]]:
        return self.search_batch_async(vectors, k, flt, refine=refine)()

    def search_batch_async(self, vectors: np.ndarray, k: int,
                           flt: Optional[VectorFilter] = None, *,
                           refine: bool = True):
        """Dispatch without fetching; returns a zero-arg callable that
        blocks for the hits, so callers can overlap device work with
        host work."""
        vectors = np.asarray(vectors, np.float32)
        if vectors.ndim != 2:
            raise IndexError_("search_batch expects [B, d]")
        flt = flt or VectorFilter()
        finish = self._corpus.topk_async(
            vectors, k, kinds=flt.kinds, agent=flt.source_agent,
            exclude_ids=flt.exclude_ids, refine=refine)
        return lambda: _hits(*finish())

    def search_stream(self, vectors: np.ndarray, k: int,
                      flt: Optional[VectorFilter] = None,
                      batch: int = 512, *,
                      refine: bool = True) -> List[List[SearchHit]]:
        """Bulk search over a query stream with one device-to-host
        fetch; the same results as search_batch."""
        vectors = np.asarray(vectors, np.float32)
        if vectors.ndim != 2:
            raise IndexError_("search_stream expects [NQ, d]")
        flt = flt or VectorFilter()
        return _hits(*self._corpus.topk_stream(
            vectors, k, batch=batch, kinds=flt.kinds,
            agent=flt.source_agent, exclude_ids=flt.exclude_ids,
            refine=refine))

    def close(self) -> None:
        self._corpus.release()

    def __len__(self) -> int:
        return len(self._corpus)

    def __contains__(self, node_id: str) -> bool:
        return node_id in self._corpus

    def index_info(self) -> dict:
        co = self._corpus
        return {
            "kind": "flat",
            "size": len(co),
            "capacity": int(co._cap),
            "storage_dtype": ("bfloat16"
                              if co._storage_dtype == torch.bfloat16
                              else "float32"),
            "search_path": co._search_path,          # configured
            "resolved_path": co._choose_path(8),     # what serves now
            "device": str(co._device),
        }


def _hits(scores: np.ndarray, ids) -> List[List[SearchHit]]:
    """(scores [B, k], ids [B][k]) -> per-query hit lists, dead hits
    (id None) dropped."""
    return [[(nid, float(scores[b, j])) for j, nid in enumerate(row)
             if nid is not None]
            for b, row in enumerate(ids)]
