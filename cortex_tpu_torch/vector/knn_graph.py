"""kNN graph over the IVF block layout: the refinement structure.

Counterpart of cortex_tpu/vector/knn_graph.py. IVF's candidate recall is
capped by rows whose clusters rank low against the query; a missed
top-10 row is, with high probability, a near neighbour of a found one.
The graph keeps each row's top `degree` neighbours ([cap, degree] int32),
and the search path expands its candidate frontier through it into the
exact re-rank (IvfCorpus._expand_candidates).

Build (device): each chunk of clusters goes through N1
(ops/knn_graph.py::block_knn, csrc/block_knn.cu on the card), which
scores every within-cluster pair from the int8 layout and keeps each
slot's top r; spill packing already puts boundary rows in two clusters,
so their two lists hold the cross-cluster edges. The chunks' lists are
concatenated and stay on the device.

Merge (device, `merge_lists`): rows with one copy take their list as it
is; spilled rows interleave their two score-ordered lists position by
position, drop duplicates (keep first: `dedup_keep_first_torch`, the
same stable sort) and compact. Only the finished [cap, degree] table is
fetched. The result equals the reference's host merge in numpy.

`dedup_keep_first` and `_chunk_clusters` are the reference's, identical
but for imports (the search path's expansion dedups on the host with
`dedup_keep_first`).
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np
import torch

from ..ops.knn_graph import block_knn, slot_mu_dot

log = logging.getLogger("cortex.knn_graph")

#: cluster-axis chunk budget: the reference's [CH, L, L] int32+fp32 score
#: planes. N1 writes no such plane, so here the budget only sets the
#: chunk size, kept so that the final chunk overlaps as the reference's
#: does; the plain version (CPU) still materializes the planes
GRAPH_BUDGET_BYTES = 1 << 30


def dedup_keep_first(vals: np.ndarray, valid: np.ndarray
                     ) -> np.ndarray:
    """Row-wise duplicate masking for [B, C] candidate lists: among
    entries with equal values, keep the FIRST (original order — the
    stable sort ties break by position) and mark the rest invalid.
    Invalid entries never collide (keyed as -1, grouped apart from
    real row 0). Returns the narrowed validity mask."""
    key = np.where(valid, vals, -1)
    o = np.argsort(key, axis=1, kind="stable")
    sk = np.take_along_axis(key, o, axis=1)
    dup = np.zeros_like(valid)
    dup[:, 1:] = (sk[:, 1:] == sk[:, :-1]) & (sk[:, 1:] >= 0)
    dd = np.zeros_like(valid)
    np.put_along_axis(dd, o, dup, axis=1)
    return valid & ~dd


def dedup_keep_first_torch(vals: torch.Tensor, valid: torch.Tensor
                           ) -> torch.Tensor:
    """`dedup_keep_first` on torch tensors of any device: the same
    stable sort by key (ties by position), the same narrowed mask."""
    key = torch.where(valid, vals, torch.full_like(vals, -1))
    sk, o = torch.sort(key, dim=1, stable=True)
    dup = torch.zeros_like(valid)
    dup[:, 1:] = (sk[:, 1:] == sk[:, :-1]) & (sk[:, 1:] >= 0)
    return valid & ~torch.zeros_like(valid).scatter_(1, o, dup)


def merge_lists(lists: torch.Tensor, list_of: np.ndarray, *, degree: int,
                cap: int, rows: np.ndarray, cluster_of: np.ndarray,
                slot_of: np.ndarray, cluster_of2: np.ndarray,
                slot_of2: np.ndarray) -> torch.Tensor:
    """The [cap, degree] int32 neighbour table, on lists' device.

    lists [n, L, r0] int32: N1's per-slot lists; list_of [C] int: the
    index in lists of each cluster of the layout. Rows with one copy
    take their slot's list; spilled rows interleave their two lists
    position by position, drop themselves and duplicates (first kept)
    and compact to `degree`. Rows outside `rows` stay -1."""
    dev = lists.device
    r0 = int(lists.shape[2])
    out = torch.full((cap, degree), -1, dtype=torch.int32, device=dev)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(dev)

    def at(cl, sl):
        return lists[up(list_of[cl]), up(sl)]             # [k, r0]

    has2 = cluster_of2[rows] >= 0
    solo = rows[~has2]
    if len(solo):
        # within one block all slots are distinct rows, so self-edges
        # are already masked by the kernel: copy straight through
        out[up(solo), :r0] = at(cluster_of[solo], slot_of[solo])
    rs = rows[has2]
    if len(rs):
        a = at(cluster_of[rs], slot_of[rs])
        sec = at(cluster_of2[rs], slot_of2[rs])
        # positional interleave of two desc-sorted lists
        cand = torch.stack((a, sec), dim=2).reshape(len(rs), 2 * r0)
        rs_d = up(rs)
        valid = dedup_keep_first_torch(
            cand, (cand >= 0) & (cand != rs_d[:, None]))
        comp = torch.sort((~valid).to(torch.uint8), dim=1,
                          stable=True).indices[:, :degree]
        res = torch.gather(torch.where(valid, cand, -1), 1, comp)
        out[rs_d, :res.shape[1]] = res
    return out


def _chunk_clusters(c: int, lcap: int) -> int:
    """Cluster-axis chunk size: power of two keeping the [CH, L, L]
    score planes (8 bytes/entry across the int32+fp32 stages) under
    budget."""
    ch = max(1, GRAPH_BUDGET_BYTES // max(1, 8 * lcap * lcap))
    p = 1
    while p * 2 <= min(ch, c):
        p *= 2
    return p


def build_knn_graph(emb_i8, rinv_sl, slot_rows, mu, *, degree: int,
                    cap: int, rows: np.ndarray,
                    cluster_of: np.ndarray, slot_of: np.ndarray,
                    cluster_of2: np.ndarray, slot_of2: np.ndarray,
                    device=None, stats: Optional[dict] = None
                    ) -> Optional[np.ndarray]:
    """Build the [cap, degree] neighbour table from the block layout.

    emb_i8 / rinv_sl / slot_rows: the layout planes ([C, L, d] int8, [C, L]
    f32 and int32), device tensors (read in place) or host numpy arrays
    (each chunk is uploaded to `device`). mu: the centering vector the
    layout was quantized with. rows: live global rows; cluster_of /
    slot_of (+2: the spill copy, -1 when none) index the layout per row.
    stats, when given, receives the wall seconds of the device work
    (uploads and launches until the lists are done), the merge (on the
    lists' device) and the table's fetch, and the number of chunks."""
    t0 = time.monotonic()
    c, lcap = int(emb_i8.shape[0]), int(emb_i8.shape[1])
    r0 = min(degree, lcap - 1)
    if r0 <= 0 or len(rows) == 0:
        return None
    ch = _chunk_clusters(c, lcap)
    host = isinstance(emb_i8, np.ndarray)
    dev = torch.device(device or "cpu") if host else emb_i8.device
    mu_d = torch.from_numpy(np.asarray(mu, np.float32)).to(dev)
    # fixed chunk shape without padding the layout: the final chunk
    # clamps its start and overlaps the previous one; the overlapped
    # clusters get identical lists, and list_of below reads the later one
    starts = list(range(0, max(1, c - ch + 1), ch))
    if starts[-1] + ch < c:
        starts.append(c - ch)
    chunks = []
    for s in starts:
        if host:
            blk, ri, sr = (torch.from_numpy(a[s:s + ch]).to(dev)
                           for a in (emb_i8, rinv_sl, slot_rows))
        else:
            blk, ri, sr = (a[s:s + ch] for a in (emb_i8, rinv_sl,
                                                 slot_rows))
        chunks.append(block_knn(blk, ri, sr, slot_mu_dot(blk, ri, mu_d),
                                r0))
    big = torch.cat(chunks)
    sync = (torch.cuda.current_stream(big.device).synchronize
            if big.is_cuda else (lambda: None))
    sync()                  # time the device work apart from the merge
    t_dev = time.monotonic()
    # each cluster's index in the chunks' lists
    list_of = np.empty(c, np.int64)
    for j, s in enumerate(starts):
        list_of[s:s + ch] = j * ch + np.arange(min(ch, c - s))
    out = merge_lists(big, list_of, degree=degree, cap=cap, rows=rows,
                      cluster_of=cluster_of, slot_of=slot_of,
                      cluster_of2=cluster_of2, slot_of2=slot_of2)
    sync()
    t_merge = time.monotonic()
    out = out.cpu().numpy()                       # one fetch: the table
    t_end = time.monotonic()
    if stats is not None:
        stats.update(device_s=t_dev - t0, merge_s=t_merge - t_dev,
                     fetch_s=t_end - t_merge, chunks=len(starts),
                     chunk_clusters=ch, r=r0)
    deg = float((out[rows] >= 0).mean()) * degree
    log.info("knn graph: %d rows, degree %d (mean filled %.1f), "
             "%d clusters x %d chunked %d, %.2fs",
             len(rows), degree, deg, c, lcap, ch, t_end - t0)
    return out
