"""Vector index interface of the port.

Counterpart of cortex_tpu/vector/index.py: `VectorFilter`, `SearchHit`
and the `VectorIndex` contract (insert / insert_batch / remove /
search / search_batch / search_threshold / len / contains), plus
`TorchFlatIndex`, which holds what every corpus-backed index shares and
`TorchIvfIndex` (vector/ivf.py) inherits. The flat device search itself
is not ported yet, so TorchFlatIndex cannot be built on its own.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from cortex_tpu.errors import ConfigError, IndexError_

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
               flt: Optional[VectorFilter] = None) -> List[SearchHit]:
        return self.search_batch(np.asarray(vector)[None, :], k, flt)[0]

    def search_batch(self, vectors: np.ndarray, k: int,
                     flt: Optional[VectorFilter] = None
                     ) -> List[List[SearchHit]]:
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


class TorchFlatIndex(VectorIndex):
    """Corpus-backed index: the methods TorchIvfIndex inherits. The
    corpus (`self._corpus`) is built by the subclass."""

    def __init__(self, dim: int, *, device="cuda"):
        raise ConfigError(
            "the flat device search is not ported yet (ROADMAP queue A, "
            "'Flat search (K1/K2)'); use TorchIvfIndex")

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
                     flt: Optional[VectorFilter] = None
                     ) -> List[List[SearchHit]]:
        vectors = np.asarray(vectors, np.float32)
        if vectors.ndim != 2:
            raise IndexError_("search_batch expects [B, d]")
        flt = flt or VectorFilter()
        scores, ids = self._corpus.topk(
            vectors, k, kinds=flt.kinds, agent=flt.source_agent,
            exclude_ids=flt.exclude_ids)
        return [[(nid, float(scores[b, j]))
                 for j, nid in enumerate(ids[b]) if nid is not None]
                for b in range(vectors.shape[0])]

    def __len__(self) -> int:
        return len(self._corpus)

    def __contains__(self, node_id: str) -> bool:
        return node_id in self._corpus
