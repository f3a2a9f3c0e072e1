"""The plain reference of a hybrid search: vector similarity x graph
proximity, as crates/cortex-core/src/vector/hybrid.rs:95-225 defines it.

Plain PyTorch over what the benchmark generated (the rows, the edge
list, the queries with their anchors and filters; never anything the
program built from them), float32 with TF32 off, in blocks of rows:

- the vector leg: each query's exact cosine top `fetch` (3 x the limit)
  over the rows its kind filter admits (`filtered_topk`);
- proximity: hop depths from each anchor over the undirected edge list,
  by frontier expansion over the whole list (`depths_at`); an anchor is
  at depth 0 from itself, with edges or without;
- the fusion (`fuse`): a candidate's graph score is 1 / (1 + d) for the
  least depth d <= the hop limit from any anchor, its nearest anchor the
  first in the query's order at that depth (0 and no anchor beyond the
  limit); combined = w v + (1 - w) g; a stable sort on combined, best
  first, and the first `limit`.

`tf32=True` gives the control's vector leg: the same product in TF32 on
the card, its operand rounding emulated elsewhere.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .reference import ROW_BLOCK, precision, unit

UNREACHED = 127
#: anchors expanded together: [block, 2 E] booleans a hop
ANCHOR_BLOCK = 16


def filtered_topk(rows: np.ndarray, kind_of: np.ndarray,
                  queries: np.ndarray, admitted: np.ndarray, k: int,
                  dev: torch.device, *, tf32: bool = False):
    """Top-k cosine scores and row numbers of every query over the rows
    whose kind it admits. kind_of: [N] kind number of each row;
    admitted: [P, kinds] bool. Returns (scores [P, k] float32, rows [P,
    k] int64), best first."""
    dev = torch.device(dev)
    adm = torch.from_numpy(admitted).to(dev)
    kinds = torch.from_numpy(kind_of).to(dev)
    with precision(dev, tf32) as rnd:
        q = rnd(unit(torch.from_numpy(queries).to(dev)))
        best_v = best_i = None
        for s in range(0, rows.shape[0], ROW_BLOCK):
            blk = rnd(unit(torch.from_numpy(rows[s:s + ROW_BLOCK]).to(dev)))
            sc = (q @ blk.T).masked_fill(~adm[:, kinds[s:s + ROW_BLOCK]],
                                         float("-inf"))
            v, i = torch.topk(sc, min(k, blk.shape[0]), dim=1)
            i = i + s
            if best_v is not None:
                v = torch.cat([best_v, v], 1)
                i = torch.cat([best_i, i], 1)
                v, sel = torch.topk(v, min(k, v.shape[1]), dim=1)
                i = torch.gather(i, 1, sel)
            best_v, best_i = v, i
    return best_v.cpu().numpy(), best_i.cpu().numpy()


def depths_at(src: np.ndarray, dst: np.ndarray, n: int,
              anchors: np.ndarray, at: np.ndarray, hops: int,
              dev: torch.device) -> np.ndarray:
    """Hop depth from anchor anchors[a] to each row at[a, j] over the
    undirected edges (src, dst), UNREACHED beyond `hops`: [A, M] int8.
    Each hop marks every row that an edge leads to from the frontier."""
    dev = torch.device(dev)
    u = torch.from_numpy(np.concatenate((src, dst))).to(dev)
    v = torch.from_numpy(np.concatenate((dst, src))).to(dev)
    out = np.empty(at.shape, np.int8)
    for s in range(0, len(anchors), ANCHOR_BLOCK):
        a = torch.from_numpy(anchors[s:s + ANCHOR_BLOCK]).to(dev)
        b = len(a)
        lane = torch.arange(b, device=dev)
        depth = torch.full((b, n), UNREACHED, dtype=torch.int8, device=dev)
        depth[lane, a] = 0
        frontier = torch.zeros((b, n), dtype=torch.bool, device=dev)
        frontier[lane, a] = True
        for h in range(1, hops + 1):
            lanes, edge = frontier[:, u].nonzero(as_tuple=True)
            reached = torch.zeros((b, n), dtype=torch.bool, device=dev)
            reached[lanes, v[edge]] = True
            frontier = reached & (depth == UNREACHED)
            depth[frontier] = h
        at_b = torch.from_numpy(at[s:s + ANCHOR_BLOCK]).to(dev)
        out[s:s + b] = torch.gather(depth, 1, at_b).cpu().numpy()
    return out


def graph_score(depths: Sequence[int], anchors: Sequence[str],
                hops: int) -> Tuple[float, Optional[Tuple[str, int]]]:
    """(graph score, nearest anchor) of one row from its depth from each
    anchor, in the query's order."""
    if len(depths) == 0:
        return 0.0, None
    j = int(np.argmin(depths))          # the first at the least depth
    d = int(depths[j])
    if d > hops:
        return 0.0, None
    return 1.0 / (1.0 + d), (anchors[j], d)


def fuse(rows: Sequence[int], scores: Sequence[float], depths: np.ndarray,
         anchors: Sequence[str], ids: Sequence[str], w: float, hops: int,
         limit: int) -> List[tuple]:
    """One query's fused answer from its vector leg (rows and scores,
    best first) and each row's depths from its anchors ([A, len(rows)]):
    (id, vector score, graph score, combined, nearest anchor) rows, the
    first `limit` by combined score, ties in vector order."""
    out = []
    for j, (r, v) in enumerate(zip(rows, scores)):
        g, nearest = graph_score(depths[:, j], anchors, hops)
        out.append((ids[r], float(v), g, w * float(v) + (1.0 - w) * g,
                    nearest))
    out.sort(key=lambda t: -t[3])       # stable: ties keep vector order
    return out[:limit]
