"""Hop depths over the device graph mirror's neighbor table: the frontier
walk (G1) and the min-plus relaxation (G2).

Counterpart of the XLA programs of cortex_tpu/graph/csr.py:

  * `frontier_bfs` (G1) replaces `_frontier_bfs_device` (line 70): a
    walk of at most 8 hops from a few anchors that touches only the
    frontier, with an overflow flag when a hop finds more than `cap` new
    (slot, column) pairs. `frontier_bfs_compact` (G1, the same kernel)
    replaces `_frontier_bfs_device_compact` (line 120): the walk's
    reached (row, depth) pairs, their count and the flag, in one launch
    with no pass over all N rows (it keeps a caller's scratch).
  * `bfs_relax` (G2) replaces `_bfs_hops` (line 47), vmapped over
    anchors (line 509): min(hops, 8) rounds of min-plus over [A, N].

The table is nbrs [N, D] int32 with -1 (any entry outside [0, N)) as
padding; depths are int32 with INF_DEPTH (2^30) for unreached rows.

Each wrapper checks its arguments, then dispatches on the tensors'
device with exactly two branches: CUDA tensors launch the hand-written
kernel (csrc/graph_bfs.cu, built at first use by ops/build.py) and count
the launch; CPU tensors run the plain torch version beside it
(`frontier_bfs_plain`, `frontier_bfs_compact_plain`, `bfs_relax_plain`),
which the CPU tests hold to
the reference and chip_smoke.py holds each kernel against on the card.
A CUDA launch never falls back.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from .build import load_ops

INF_DEPTH = 2 ** 30
#: the reference's static hop ceiling (the 8-round fori_loop of _bfs_hops)
MAX_HOPS = 8
#: table rows the plain relaxation gathers at a time: an unchunked
#: gather of [A, N, D] is 20 GB at 10M x 64 and 8 anchors
RELAX_CHUNK_ROWS = 1 << 16
#: most depths (anchors x N) one relaxation call holds: larger anchor sets
#: run in chunks of whole anchors (independent in G2, so the result is
#: the same), which bounds the kernel's two anchor-minor buffers to 8 GB
RELAX_MAX_ENTRIES = 1 << 30


def _check_table(op: str, nbrs: torch.Tensor) -> None:
    if nbrs.dtype != torch.int32 or nbrs.dim() != 2:
        raise ValueError(f"{op}: nbrs must be an [N, D] int32 table, got "
                         f"{nbrs.dtype} {tuple(nbrs.shape)}")
    if nbrs.shape[0] < 1 or nbrs.shape[1] < 1:
        raise ValueError(f"{op}: nbrs must have N, D >= 1, got "
                         f"{tuple(nbrs.shape)}")


# ------------------------------------------------------- G1: the walk


def _check_walk(op: str, nbrs: torch.Tensor, anchors: torch.Tensor,
                hops: int, cap: int) -> torch.Tensor:
    """Checks a walk's arguments; returns the anchors on the table's
    device. Anchors on the host are range-checked there and copied
    without waiting for the stream; anchors on the card cost a host sync
    for the range check, so callers on a latency path pass host anchors."""
    _check_table(op, nbrs)
    if anchors.dtype != torch.int32 or anchors.dim() != 1:
        raise ValueError(f"{op}: anchors must be [A] int32, got "
                         f"{anchors.dtype} {tuple(anchors.shape)}")
    if anchors.device not in (nbrs.device, torch.device("cpu")):
        raise ValueError(f"{op}: anchors on {anchors.device} for a table "
                         f"on {nbrs.device}")
    if not 0 <= hops <= MAX_HOPS:
        raise ValueError(f"{op}: hops={hops} out of range [0, {MAX_HOPS}]")
    if cap < 1 or anchors.shape[0] > cap:
        raise ValueError(f"{op}: {anchors.shape[0]} anchors and cap={cap}: "
                         f"need 1 <= cap and A <= cap")
    if anchors.numel() and int(anchors.max()) >= nbrs.shape[0]:
        raise ValueError(f"{op}: anchor {int(anchors.max())} lies outside "
                         f"the table's {nbrs.shape[0]} rows")
    return anchors.to(nbrs.device, non_blocking=True)


def frontier_bfs(nbrs: torch.Tensor, anchors: torch.Tensor, hops: int,
                 cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """G1: hop depths from `anchors` [A] int32 (< 0 = none; A <= cap; on
    the host or on the table's device) within `hops` (0..8) hops over
    nbrs, walking a frontier of at most `cap` (slot) entries. Returns
    (dist [N] int32, overflow bool tensor): overflow is set when some
    hop found more than `cap` new pairs, and then dist holds a subset of
    the depths. An anchor outside the table raises."""
    anchors = _check_walk("frontier_bfs", nbrs, anchors, hops, cap)
    dev = nbrs.device
    if dev.type == "cuda":
        out = load_ops().frontier_bfs(nbrs, anchors, int(hops), int(cap))
        frontier_bfs.launches += 1
        return out
    if dev.type == "cpu":
        return frontier_bfs_plain(nbrs, anchors, hops, cap)
    raise RuntimeError(f"frontier_bfs has no kernel for device {dev}")


#: kernel launches since the last reset (chip_smoke.py reads it to show
#: the main path went through the kernel)
frontier_bfs.launches = 0


def frontier_bfs_plain(nbrs: torch.Tensor, anchors: torch.Tensor, hops: int,
                       cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`frontier_bfs` in plain torch, step for step the reference's
    program: per hop, gather the frontier's rows, mark the pairs whose
    target is unreached at the hop's start, set their depth, and keep
    the first `cap` of them (duplicates included, in pair order) as the
    next frontier."""
    n = nbrs.shape[0]
    dev = nbrs.device
    dist = torch.full((n,), INF_DEPTH, dtype=torch.int32, device=dev)
    dist[anchors[anchors >= 0].long()] = 0
    frontier = torch.full((cap,), -1, dtype=torch.int32, device=dev)
    frontier[:anchors.shape[0]] = anchors
    overflow = False
    for h in range(hops):
        nb = nbrs[frontier.clamp_min(0).long()]                # [cap, D]
        ok = (frontier[:, None] >= 0) & (nb >= 0) & (nb < n)
        flat = torch.where(ok, nb, -1).reshape(-1)
        isnew = (flat >= 0) & (dist[flat.clamp_min(0).long()] == INF_DEPTH)
        new = flat[isnew]
        dist[new.long()] = h + 1
        overflow |= new.numel() > cap
        frontier = torch.full((cap,), -1, dtype=torch.int32, device=dev)
        frontier[:min(cap, new.numel())] = new[:cap]
    return dist, torch.tensor(overflow, device=dev)


def frontier_bfs_compact(nbrs: torch.Tensor, anchors: torch.Tensor,
                         hops: int, cap: int, out_cap: int,
                         scratch: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """G1's walk returning only what it reached: one int32 tensor
    [2 + 2 * out_cap] holding the number of distinct rows reached (the
    anchors included), the overflow flag (as `frontier_bfs`'s), then the
    first out_cap reached rows and their depths (see `unpack_compact`).
    Each row is listed once, in no fixed order. `scratch` is an [N]
    int32 tensor on the table's device holding INF_DEPTH everywhere: the
    kernel uses it for the walk's depths and leaves it as it found it,
    so a caller keeps one per table and walks never pay for an [N] pass.
    Without one, the kernel gets a freshly filled scratch. Calls that
    share a scratch must be enqueued on one stream. With host anchors
    the call enqueues without a host sync. On the CPU the plain version
    runs and needs no scratch."""
    anchors = _check_walk("frontier_bfs_compact", nbrs, anchors, hops, cap)
    if out_cap < 1:
        raise ValueError(f"frontier_bfs_compact: out_cap={out_cap} < 1")
    n, dev = nbrs.shape[0], nbrs.device
    if scratch is not None and (
            scratch.dtype != torch.int32 or tuple(scratch.shape) != (n,)
            or scratch.device != dev):
        raise ValueError(f"frontier_bfs_compact: scratch must be [{n}] "
                         f"int32 on {dev}, got {scratch.dtype} "
                         f"{tuple(scratch.shape)} on {scratch.device}")
    if dev.type == "cuda":
        if scratch is None:
            scratch = torch.full((n,), INF_DEPTH, dtype=torch.int32,
                                 device=dev)
        out = load_ops().frontier_bfs_compact(nbrs, anchors, int(hops),
                                              int(cap), int(out_cap),
                                              scratch)
        frontier_bfs_compact.launches += 1
        return out
    if dev.type == "cpu":
        return frontier_bfs_compact_plain(nbrs, anchors, hops, cap, out_cap)
    raise RuntimeError(f"frontier_bfs_compact has no kernel for device "
                       f"{dev}")


#: kernel launches since the last reset
frontier_bfs_compact.launches = 0


def frontier_bfs_compact_plain(nbrs: torch.Tensor, anchors: torch.Tensor,
                               hops: int, cap: int,
                               out_cap: int) -> torch.Tensor:
    """`frontier_bfs_compact` in plain torch, through `frontier_bfs_plain`:
    the reached rows by depth, then row (the reference's top_k order),
    the first out_cap of them kept; unused entries hold -1."""
    dist, overflow = frontier_bfs_plain(nbrs, anchors, hops, cap)
    reached = torch.nonzero(dist <= hops).flatten()
    rows = reached[torch.argsort(dist[reached], stable=True)]
    kept = min(rows.numel(), out_cap)
    out = torch.full((2 + 2 * out_cap,), -1, dtype=torch.int32,
                     device=nbrs.device)
    out[0] = rows.numel()
    out[1] = int(bool(overflow))
    out[2:2 + kept] = rows[:kept].to(torch.int32)
    out[2 + out_cap:2 + out_cap + kept] = dist[rows[:kept]]
    return out


def unpack_compact(packed) -> Tuple[Any, Any, int, bool]:
    """(rows, depths, count, overflow) of a `frontier_bfs_compact` result
    (a tensor or a numpy array, usually fetched to the host once): rows
    and depths are the min(count, out_cap) pairs kept; count is the
    number of distinct rows reached, which exceeds what was kept when
    the output filled."""
    out_cap = (packed.shape[0] - 2) // 2
    count = int(packed[0])
    kept = min(count, out_cap)
    return (packed[2:2 + kept], packed[2 + out_cap:2 + out_cap + kept],
            count, bool(packed[1]))


# ------------------------------------------------- G2: the relaxation


def bfs_relax(nbrs: torch.Tensor, dist0: torch.Tensor,
              hops: int) -> torch.Tensor:
    """G2: min(hops, 8) rounds (none when hops <= 0) of
    dist <- min(dist, min_c dist[nbrs[:, c]] + 1) over dist0 [A, N]
    int32, each round reading the previous round's depths. Returns a new
    [A, N] int32 tensor. More than RELAX_MAX_ENTRIES depths run as
    chunks of anchors, a call (and a launch) each."""
    _check_table("bfs_relax", nbrs)
    if (dist0.dtype != torch.int32 or dist0.dim() != 2
            or dist0.shape[1] != nbrs.shape[0] or dist0.shape[0] < 1):
        raise ValueError(f"bfs_relax: dist0 must be [A >= 1, "
                         f"{nbrs.shape[0]}] int32, got {dist0.dtype} "
                         f"{tuple(dist0.shape)}")
    dev = nbrs.device
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"bfs_relax has no kernel for device {dev}")
    step = max(1, RELAX_MAX_ENTRIES // nbrs.shape[0])
    a = dist0.shape[0]
    if a <= step:
        return _relax(nbrs, dist0, hops)
    out = torch.empty_like(dist0)
    for a0 in range(0, a, step):
        out[a0:a0 + step] = _relax(nbrs, dist0[a0:a0 + step], hops)
    return out


def _relax(nbrs: torch.Tensor, dist0: torch.Tensor,
           hops: int) -> torch.Tensor:
    if nbrs.device.type == "cuda":
        out = load_ops().bfs_relax(nbrs, dist0, int(hops))
        bfs_relax.launches += 1
        return out
    return bfs_relax_plain(nbrs, dist0, hops)


#: kernel launches since the last reset
bfs_relax.launches = 0


def bfs_relax_plain(nbrs: torch.Tensor, dist0: torch.Tensor,
                    hops: int) -> torch.Tensor:
    """`bfs_relax` in plain torch: the reference's masked min-plus round,
    gathered RELAX_CHUNK_ROWS table rows at a time, int32 throughout."""
    n = nbrs.shape[0]
    cur = dist0.clone()
    for _ in range(max(0, min(hops, MAX_HOPS))):
        nxt = torch.empty_like(cur)
        for r0 in range(0, n, RELAX_CHUNK_ROWS):
            nb = nbrs[r0:r0 + RELAX_CHUNK_ROWS]
            ok = (nb >= 0) & (nb < n)
            vals = cur[:, torch.where(ok, nb, 0).long()]     # [A, rows, D]
            vals = torch.where(ok, vals, INF_DEPTH)
            nxt[:, r0:r0 + nb.shape[0]] = torch.minimum(
                cur[:, r0:r0 + nb.shape[0]], vals.amin(dim=2) + 1)
        cur = nxt
    return cur
