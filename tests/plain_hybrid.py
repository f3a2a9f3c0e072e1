"""A plain hybrid search, for the port's tests: vector similarity x graph
proximity as crates/cortex-core/src/vector/hybrid.rs:95-225 defines it,
written from that definition in plain torch on the CPU, float32, over the
rows, kinds, edge list and queries a test made. It imports no JAX and
nothing of the port.

- the vector leg: the exact cosine top `fetch` over the rows whose kind
  the query admits;
- proximity: hop depths from each anchor over the undirected edges, by
  frontier expansion over the whole list; an anchor is at depth 0 from
  itself, with edges or without;
- the fusion: graph score 1 / (1 + d) for the least depth d <= the hop
  limit from any anchor, the nearest anchor the first in the query's
  order at that depth; combined = w v + (1 - w) g; a stable sort on
  combined, best first; the first `limit`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

UNREACHED = 127


def vector_leg(rows: np.ndarray, kinds: Sequence[str], query: np.ndarray,
               kind_filter: Optional[Sequence[str]], fetch: int):
    """(rows, float32 cosines) of the query's top `fetch`, best first."""
    r = torch.from_numpy(rows).float()
    r = r / r.norm(dim=1, keepdim=True)
    q = torch.from_numpy(query).float()
    q = q / q.norm()
    s = r @ q
    if kind_filter is not None:
        keep = torch.tensor([k in kind_filter for k in kinds])
        s = s.masked_fill(~keep, float("-inf"))
    v, i = torch.topk(s, fetch)
    return i.tolist(), v.tolist()


def depths(src: np.ndarray, dst: np.ndarray, n: int, anchor: int,
           hops: int) -> np.ndarray:
    """[n] int8 hop depths from `anchor` over the undirected edges,
    UNREACHED beyond `hops`."""
    u = torch.from_numpy(np.concatenate((src, dst)))
    v = torch.from_numpy(np.concatenate((dst, src)))
    d = torch.full((n,), UNREACHED, dtype=torch.int8)
    d[anchor] = 0
    frontier = torch.zeros(n, dtype=torch.bool)
    frontier[anchor] = True
    for h in range(1, hops + 1):
        reached = torch.zeros(n, dtype=torch.bool)
        reached[v[frontier[u]]] = True
        frontier = reached & (d == UNREACHED)
        d[frontier] = h
    return d.numpy()


def hybrid_search(rows: np.ndarray, ids: Sequence[str],
                  kinds: Sequence[str], src: np.ndarray, dst: np.ndarray,
                  query: np.ndarray, anchors: Sequence[str], *,
                  kind_filter: Optional[Sequence[str]] = None,
                  w: float = 0.7, limit: int = 10, hops: int = 3
                  ) -> List[tuple]:
    """(id, vector score, graph score, combined, nearest anchor) of the
    query's top `limit`. Without anchors, the vector leg's first `limit`
    with graph score 0 and combined = the vector score."""
    cand, scores = vector_leg(rows, kinds, query, kind_filter, 3 * limit)
    if not anchors:
        return [(ids[r], v, 0.0, v, None)
                for r, v in zip(cand, scores)][:limit]
    row_of = {s: r for r, s in enumerate(ids)}
    per = np.stack([depths(src, dst, len(ids), row_of[a], hops)
                    for a in anchors])
    out = []
    for r, v in zip(cand, scores):
        g, nearest = 0.0, None
        j = int(np.argmin(per[:, r]))
        d = int(per[j, r])
        if d <= hops:
            g, nearest = 1.0 / (1.0 + d), (anchors[j], d)
        out.append((ids[r], v, g, w * v + (1.0 - w) * g, nearest))
    out.sort(key=lambda t: -t[3])
    return out[:limit]
