"""Seeded inputs of the hybrid configurations: the clustered rows with
each row's cluster, a seeded edge set over them, and the undirected
neighbours of a row in that edge set.

Frozen copies, so that a later change to the repository's generators
cannot move the yardstick: `clustered_rows_and_members` draws exactly
what data.clustered_rows draws from the same generator (the same rows)
and also returns each row's center; `seeded_edges` is the repository's
seeded edge generator of phase 7 of its chip smoke run.
"""

from __future__ import annotations

import numpy as np
import torch


def clustered_rows_and_members(gen, dev, n, d, *, groups, spread=0.35):
    """data.clustered_rows's (rows [n, d], centers [groups, d]), float32
    on dev, and each row's center number [n] (int64 on dev)."""
    centers = torch.randn((groups, d), device=dev, generator=gen)
    centers /= centers.norm(dim=1, keepdim=True)
    member = torch.randint(0, groups, (n,), device=dev, generator=gen)
    x = centers[member] + spread * torch.randn(
        (n, d), device=dev, generator=gen) / d ** 0.5
    return x / x.norm(dim=1, keepdim=True), centers, member


def seeded_edges(member, n_edges, seed, cap=64):
    """(src, dst) row arrays of about n_edges distinct directed edges
    over rows with centers `member` (a host int64 array): Pareto-tailed
    out-degree, 80 % of the targets in the row's own cluster and 20 %
    anywhere, no self loops (a storage holds one edge a pair and
    relation), every 1000th row (i % 1000 == 999) without edges, and at
    most `cap` distinct neighbours a row (each row keeps its first `cap`
    in a seeded order)."""
    rng = np.random.default_rng(seed)
    n = len(member)
    linked = np.arange(n) % 1000 != 999
    w = rng.pareto(2.0, n) + 1.0
    w[~linked] = 0.0
    src = np.repeat(np.arange(n, dtype=np.int64),
                    rng.poisson(w * (n_edges / w.sum())))
    order = np.argsort(member, kind="stable")
    sizes = np.bincount(member)
    starts = np.concatenate(([0], np.cumsum(sizes)[:-1]))
    c = member[src]
    local = order[starts[c] + (rng.random(len(src)) * sizes[c]).astype(
        np.int64)]
    dst = np.where(rng.random(len(src)) < 0.8, local,
                   rng.integers(0, n, len(src)))
    keep = (dst != src) & linked[dst]
    src, dst = src[keep], dst[keep]
    pairs, inv = np.unique(np.minimum(src, dst) * n + np.maximum(src, dst),
                           return_inverse=True)
    pri = rng.random(len(pairs))
    ends = np.concatenate((pairs // n, pairs % n))
    pid = np.concatenate((np.arange(len(pairs)),) * 2)
    o = np.lexsort((np.concatenate((pri, pri)), ends))
    rank = np.arange(len(o)) - np.searchsorted(ends[o], ends[o])
    ok = np.ones(len(pairs), bool)
    ok[pid[o][rank >= cap]] = False
    keep = ok[inv.reshape(-1)]
    src, dst = src[keep], dst[keep]
    _, first = np.unique(src * n + dst, return_index=True)  # one per pair
    first.sort()
    return src[first], dst[first]


class Neighbours:
    """The undirected neighbours of each row in a directed edge set, as
    a CSR over both directions (a pair linked both ways is listed
    twice)."""

    def __init__(self, src: np.ndarray, dst: np.ndarray, n: int):
        u = np.concatenate((src, dst))
        v = np.concatenate((dst, src))
        order = np.argsort(u, kind="stable")
        self.nbr = v[order]
        self.ptr = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(u, minlength=n), out=self.ptr[1:])

    def degree(self) -> np.ndarray:
        return np.diff(self.ptr)

    def of(self, row: int) -> np.ndarray:
        """The distinct neighbours of `row`, ascending."""
        return np.unique(self.nbr[self.ptr[row]:self.ptr[row + 1]])
