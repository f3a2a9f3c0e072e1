"""Vector index interface of the port.

Counterpart of cortex_tpu/vector/index.py: `VectorFilter`, `SearchHit`
and the `VectorIndex` contract (insert / insert_batch / remove /
search / search_batch / search_threshold / len / contains /
index_info), plus `TorchFlatIndex`, the flat index over the device
corpus (vector/shard.py), whose corpus-backed methods `TorchIvfIndex`
(vector/ivf.py) inherits, with the reference's snapshot files: a base
npz (`write_snapshot` / `load`) and the delta links of the checkpoint
chain (`write_delta` / `apply_delta`), byte for byte in the reference's
format, so a file written by either package opens in the other; and
`rebuild`, the compaction. The mesh indexes of parallel/ share all of
it (their `_fresh_corpus` is their own); `index_info` adds their mesh.
`BruteForceIndex` is the reference's exact numpy scan, the ground truth
of the recall tests, on the host and in the same tie order (a stable
argsort, ties in insertion order).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..errors import IndexError_
from ..ops.similarity import normalize_rows
from ..utils.device import resolve_device
from ..utils.tracing import region
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

    def rebuild(self) -> None:
        """Compaction; searches are always exact, so this is
        maintenance, not a correctness step."""

    def save(self, path: str) -> None:
        raise NotImplementedError

    def load(self, path: str) -> None:
        raise NotImplementedError


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
        # ids touched since the last checkpoint capture: the next delta
        # link's contents (begin_snapshot_base swaps it out)
        self._delta_ids: set = set()

    def insert(self, node_id: str, vector: np.ndarray, *,
               kind: str = "", source_agent: str = "") -> None:
        self._corpus.upsert_batch(
            [node_id], np.asarray(vector, np.float32)[None, :],
            [kind], [source_agent])
        self._delta_ids.add(node_id)

    def insert_batch(self, ids: Sequence[str], vectors: np.ndarray, *,
                     kinds: Optional[Sequence[str]] = None,
                     agents: Optional[Sequence[str]] = None) -> None:
        if len(ids) == 0:
            return
        self._corpus.upsert_batch(
            ids, np.asarray(vectors, np.float32),
            list(kinds) if kinds else [""] * len(ids),
            list(agents) if agents else [""] * len(ids))
        self._delta_ids.update(ids)

    def remove(self, node_id: str) -> bool:
        self._delta_ids.add(node_id)
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
        host work. The callable's `call` is the search's call id in the
        trace tables (None while tracing is off)."""
        vectors = np.asarray(vectors, np.float32)
        if vectors.ndim != 2:
            raise IndexError_("search_batch expects [B, d]")
        flt = flt or VectorFilter()
        finish = self._corpus.topk_async(
            vectors, k, kinds=flt.kinds, agent=flt.source_agent,
            exclude_ids=flt.exclude_ids, refine=refine)

        def hits():
            scores, ids = finish()
            with region("search.hits", finish.call):
                return _hits(scores, ids)
        hits.call = finish.call
        return hits

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
            "storage_dtype": self._storage_dtype_str(),
            "search_path": co._search_path,          # configured
            "resolved_path": co._choose_path(8),     # what serves now
            "device": str(co._device),
            **mesh_info(co),
        }

    def rebuild(self) -> None:
        self._corpus.compact()

    # ------------------------------------------------------------ snapshots
    def snapshot_state(self):
        """Consistent host copy of the contents (array copies, no
        compression), so a caller can capture it under a lock and write
        it outside."""
        return self._corpus.state()

    def write_snapshot(self, path: str, st) -> None:
        """Write a snapshot_state() capture: an uncompressed npz of
        `vectors` and a `meta` JSON (dim, ids, kinds, agents), the
        reference's format."""
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                    exist_ok=True)
        # uncompressed: unit-norm fp32 rows do not deflate, and the
        # write's time matters more than ~5 % of the file's size
        np.savez(
            path, vectors=st["vectors"],
            meta=json.dumps({
                "dim": self.dim,
                "ids": list(st["ids"]),
                "kinds": list(st["kinds"]),
                "agents": list(st["agents"]),
            }))

    def save(self, path: str) -> None:
        self.write_snapshot(path, self.snapshot_state())

    # A live checkpoint writes one delta link: the rows touched since the
    # previous checkpoint (Cortex.save_index_snapshot chains them onto
    # the base and rewrites the base once the chain outgrows a fraction
    # of the corpus).

    def delta_size(self) -> int:
        return len(self._delta_ids)

    def begin_snapshot_base(self) -> set:
        """Pair with a capture (same lock hold): swap in an empty working
        set, so writes landing during the file write count toward the
        next link, and return the old one for abort_snapshot_base."""
        pending, self._delta_ids = self._delta_ids, set()
        return pending

    def abort_snapshot_base(self, pending: set) -> None:
        """The write failed: merge the captured working set back (the
        later links would otherwise leave its rows out)."""
        self._delta_ids |= pending

    def delta_state(self):
        """Host copies of the rows touched since the last capture, and
        the ids removed since (O(delta), under the corpus lock)."""
        return self._corpus.rows_state(sorted(self._delta_ids))

    def write_delta(self, path: str, dst, *, extra_meta=None) -> None:
        """Write a delta_state() capture; extra_meta (the chain's
        sequence numbers) joins the meta JSON."""
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                    exist_ok=True)
        meta = {"dim": self.dim,
                "ids": list(dst["ids"]),
                "kinds": list(dst["kinds"]),
                "agents": list(dst["agents"]),
                "removed": list(dst["removed"])}
        if extra_meta:
            meta.update(extra_meta)
        np.savez(path, vectors=dst["vectors"], meta=json.dumps(meta))

    def apply_delta(self, path: str) -> dict:
        """Replay a delta link on top of the loaded base; returns its
        meta."""
        z = np.load(path, allow_pickle=False)
        meta = json.loads(str(z["meta"]))
        if meta["dim"] != self.dim:
            raise IndexError_(
                f"delta dim {meta['dim']} != index dim {self.dim}")
        if meta["ids"]:
            self._corpus.upsert_batch(meta["ids"], z["vectors"],
                                      meta["kinds"], meta["agents"])
        for nid in meta["removed"]:
            self._corpus.remove(nid)
        # the state now differs from the base file by this link
        self._delta_ids.update(meta["ids"])
        self._delta_ids.update(meta["removed"])
        return meta

    @staticmethod
    def read_delta_meta(path: str) -> dict:
        z = np.load(path, allow_pickle=False)
        return json.loads(str(z["meta"]))

    def _storage_dtype_str(self) -> str:
        return ("bfloat16"
                if self._corpus._storage_dtype == torch.bfloat16
                else "float32")

    def _fresh_corpus(self) -> DeviceCorpus:
        """An empty corpus with this index's configuration and device."""
        old = self._corpus
        return DeviceCorpus(self.dim, device=old._device,
                            search_path=old._search_path,
                            storage_dtype=self._storage_dtype_str())

    def load(self, path: str) -> None:
        """Replace the contents with a base snapshot's, rows in the
        file's order (as the reference loads them). The corpus it
        replaces is released."""
        z = np.load(path, allow_pickle=False)
        meta = json.loads(str(z["meta"]))
        if meta["dim"] != self.dim:
            raise IndexError_(
                f"snapshot dim {meta['dim']} != index dim {self.dim}")
        old, self._corpus = self._corpus, self._fresh_corpus()
        old.release()
        self._delta_ids = set()           # the state equals the base file
        if meta["ids"]:
            self._corpus.upsert_batch(meta["ids"], z["vectors"],
                                      meta["kinds"], meta["agents"])


def mesh_info(corpus) -> dict:
    """index_info's "mesh" entry, {"shards", "replicas"}, for a corpus
    laid out over a device mesh (parallel/); nothing for one device."""
    if not hasattr(corpus, "_n_shard"):
        return {}
    return {"mesh": {"shards": int(corpus._n_shard),
                     "replicas": int(corpus._n_replica)}}


def _hits(scores: np.ndarray, ids) -> List[List[SearchHit]]:
    """(scores [B, k], ids [B][k]) -> per-query hit lists, dead hits
    (id None) dropped. One zip a query over plain lists: tolist() gives
    each score as float() of its numpy value."""
    return [[(nid, s) for nid, s in zip(row, vals) if nid is not None]
            for row, vals in zip(ids, scores.tolist())]


class BruteForceIndex(VectorIndex):
    """Numpy exact scan; ground truth for recall tests."""

    def __init__(self, dim: int):
        self.dim = dim
        self._vecs: Dict[str, np.ndarray] = {}
        self._kind: Dict[str, str] = {}
        self._agent: Dict[str, str] = {}

    def insert(self, node_id: str, vector: np.ndarray, *,
               kind: str = "", source_agent: str = "") -> None:
        v = np.asarray(vector, np.float32)
        if v.shape != (self.dim,):
            raise IndexError_(f"vector shape {v.shape} != ({self.dim},)")
        self._vecs[node_id] = normalize_rows(v[None, :])[0]
        self._kind[node_id] = kind
        self._agent[node_id] = source_agent

    def remove(self, node_id: str) -> bool:
        self._kind.pop(node_id, None)
        self._agent.pop(node_id, None)
        return self._vecs.pop(node_id, None) is not None

    def search_batch(self, vectors: np.ndarray, k: int,
                     flt: Optional[VectorFilter] = None, *,
                     refine: bool = True) -> List[List[SearchHit]]:
        flt = flt or VectorFilter()
        ids = [i for i in self._vecs
               if (flt.kinds is None or self._kind[i] in flt.kinds)
               and (flt.source_agent is None
                    or self._agent[i] == flt.source_agent)
               and i not in flt.exclude_ids]
        if not ids:
            return [[] for _ in range(len(vectors))]
        mat = np.stack([self._vecs[i] for i in ids])
        q = normalize_rows(np.asarray(vectors, np.float32))
        s = q @ mat.T
        out = []
        for b in range(q.shape[0]):
            order = np.argsort(-s[b], kind="stable")[:k]
            out.append([(ids[j], float(s[b, j])) for j in order])
        return out

    def __len__(self) -> int:
        return len(self._vecs)

    def __contains__(self, node_id: str) -> bool:
        return node_id in self._vecs

    def save(self, path: str) -> None:
        ids = list(self._vecs)
        np.savez_compressed(
            path,
            vectors=(np.stack([self._vecs[i] for i in ids]) if ids
                     else np.zeros((0, self.dim), np.float32)),
            meta=json.dumps({"dim": self.dim, "ids": ids,
                             "kinds": [self._kind[i] for i in ids],
                             "agents": [self._agent[i] for i in ids]}))

    def load(self, path: str) -> None:
        z = np.load(path, allow_pickle=False)
        meta = json.loads(str(z["meta"]))
        self._vecs.clear()
        self._kind.clear()
        self._agent.clear()
        for j, nid in enumerate(meta["ids"]):
            self._vecs[nid] = z["vectors"][j]
            self._kind[nid] = meta["kinds"][j]
            self._agent[nid] = meta["agents"][j]
