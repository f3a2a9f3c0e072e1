"""Seeded inputs made on the device: clustered unit rows and noisy-center
queries.

Frozen copies of the repository's generators of the same name, so that a
later change to those cannot move the yardstick. Both draw every number
from the one `torch.Generator` they are given, in a fixed order, so the
same seed gives the same rows and queries.
"""

from __future__ import annotations

import torch


def clustered_rows(gen, dev, n, d, *, groups, spread=0.35):
    """n seeded clustered unit rows on the device: `groups` random unit
    centers, each row a random center + spread * unit-scale noise.
    Returns (rows [n, d], centers [groups, d]), both float32 on dev."""
    centers = torch.randn((groups, d), device=dev, generator=gen)
    centers /= centers.norm(dim=1, keepdim=True)
    member = torch.randint(0, groups, (n,), device=dev, generator=gen)
    x = centers[member] + spread * torch.randn(
        (n, d), device=dev, generator=gen) / d ** 0.5
    return x / x.norm(dim=1, keepdim=True), centers


def noisy_centers(gen, centers, n, spread=0.35):
    """n unit queries, each a noisy copy (spread x unit-scale noise) of a
    random row of `centers`, as a host float32 array."""
    d = centers.shape[1]
    sel = torch.randint(0, centers.shape[0], (n,), device=centers.device,
                        generator=gen)
    q = centers[sel] + spread * torch.randn((n, d), device=centers.device,
                                            generator=gen) / d ** 0.5
    return (q / q.norm(dim=1, keepdim=True)).cpu().numpy()
