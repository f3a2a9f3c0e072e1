"""Hop depths over the device graph mirror's neighbor table: the frontier
walk (G1) and the min-plus relaxation (G2).

Counterpart of the XLA programs of cortex_tpu/graph/csr.py:

  * `frontier_bfs` (G1) replaces `_frontier_bfs_device` (line 70): a
    walk of at most 8 hops from a few anchors that touches only the
    frontier, with an overflow flag when a hop finds more than `cap` new
    (slot, column) pairs. `frontier_bfs_compact` adds the reference's
    compaction (`_frontier_bfs_device_compact`, line 120) as torch ops.
  * `bfs_relax` (G2) replaces `_bfs_hops` (line 47), vmapped over
    anchors (line 509): min(hops, 8) rounds of min-plus over [A, N].

The table is nbrs [N, D] int32 with -1 (any entry outside [0, N)) as
padding; depths are int32 with INF_DEPTH (2^30) for unreached rows.

Each wrapper checks its arguments, then dispatches on the tensors'
device with exactly two branches: CUDA tensors launch the hand-written
kernel (csrc/graph_bfs.cu, built at first use by ops/build.py) and count
the launch; CPU tensors run the plain torch version beside it
(`frontier_bfs_plain`, `bfs_relax_plain`), which the CPU tests hold to
the reference and chip_smoke.py holds each kernel against on the card.
A CUDA launch never falls back.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .build import load_ops

INF_DEPTH = 2 ** 30
#: the reference's static hop ceiling (the 8-round fori_loop of _bfs_hops)
MAX_HOPS = 8
#: table rows the plain relaxation gathers at a time: an unchunked
#: gather of [A, N, D] is 20 GB at 10M x 64 and 8 anchors
RELAX_CHUNK_ROWS = 1 << 16


def _check_table(op: str, nbrs: torch.Tensor) -> None:
    if nbrs.dtype != torch.int32 or nbrs.dim() != 2:
        raise ValueError(f"{op}: nbrs must be an [N, D] int32 table, got "
                         f"{nbrs.dtype} {tuple(nbrs.shape)}")
    if nbrs.shape[0] < 1 or nbrs.shape[1] < 1:
        raise ValueError(f"{op}: nbrs must have N, D >= 1, got "
                         f"{tuple(nbrs.shape)}")


# ------------------------------------------------------- G1: the walk


def frontier_bfs(nbrs: torch.Tensor, anchors: torch.Tensor, hops: int,
                 cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """G1: hop depths from `anchors` [A] int32 (< 0 = none; A <= cap)
    within `hops` (0..8) hops over nbrs, walking a frontier of at most
    `cap` (slot) entries. Returns (dist [N] int32, overflow bool tensor):
    overflow is set when some hop found more than `cap` new pairs, and
    then dist holds a subset of the depths. An anchor outside the table
    raises."""
    _check_table("frontier_bfs", nbrs)
    if anchors.dtype != torch.int32 or anchors.dim() != 1:
        raise ValueError(f"frontier_bfs: anchors must be [A] int32, got "
                         f"{anchors.dtype} {tuple(anchors.shape)}")
    if not 0 <= hops <= MAX_HOPS:
        raise ValueError(f"frontier_bfs: hops={hops} out of range "
                         f"[0, {MAX_HOPS}]")
    if cap < 1 or anchors.shape[0] > cap:
        raise ValueError(f"frontier_bfs: {anchors.shape[0]} anchors and "
                         f"cap={cap}: need 1 <= cap and A <= cap")
    if anchors.numel() and int(anchors.max()) >= nbrs.shape[0]:
        raise ValueError(f"frontier_bfs: anchor {int(anchors.max())} lies "
                         f"outside the table's {nbrs.shape[0]} rows")
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
                         hops: int, cap: int, out_cap: int
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """G1, then the reached set compacted on the device: depths capped at
    hops + 1 and the min(out_cap, N) smallest kept (torch.topk). Returns
    (rows [out_cap] int32, depth [out_cap] int32 — hops + 1 marks padding
    or unreached, overflow); ties among equal depths come in no fixed
    order."""
    dist, overflow = frontier_bfs(nbrs, anchors, hops, cap)
    capped = torch.clamp_max(dist, hops + 1)
    depth, rows = torch.topk(capped, min(out_cap, capped.shape[0]),
                             largest=False)
    return rows.to(torch.int32), depth, overflow


# ------------------------------------------------- G2: the relaxation


def bfs_relax(nbrs: torch.Tensor, dist0: torch.Tensor,
              hops: int) -> torch.Tensor:
    """G2: min(hops, 8) rounds (none when hops <= 0) of
    dist <- min(dist, min_c dist[nbrs[:, c]] + 1) over dist0 [A, N]
    int32, each round reading the previous round's depths. Returns a new
    [A, N] int32 tensor."""
    _check_table("bfs_relax", nbrs)
    if (dist0.dtype != torch.int32 or dist0.dim() != 2
            or dist0.shape[1] != nbrs.shape[0] or dist0.shape[0] < 1):
        raise ValueError(f"bfs_relax: dist0 must be [A >= 1, "
                         f"{nbrs.shape[0]}] int32, got {dist0.dtype} "
                         f"{tuple(dist0.shape)}")
    dev = nbrs.device
    if dev.type == "cuda":
        out = load_ops().bfs_relax(nbrs, dist0, int(hops))
        bfs_relax.launches += 1
        return out
    if dev.type == "cpu":
        return bfs_relax_plain(nbrs, dist0, hops)
    raise RuntimeError(f"bfs_relax has no kernel for device {dev}")


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
