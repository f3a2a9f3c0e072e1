"""The flagship single-device search step.

Counterpart of __graft_entry__.py::entry(): cosine scores of a batch of
queries over a corpus, the liveness bias, the exact top-k and the
score-decay re-rank of the candidates (temporal decay by idle days
times the access echo), re-sorted, as one step on one device. The
inputs are the reference's, made from the same seed (numpy's
default_rng(0): N 8192, D 384, B 32, K 16), so both packages rank the
same corpus.

The exact product is torch.matmul through `ops.similarity.
cosine_scores` (TF32 off on the card): the reference computes it
outside any Pallas kernel, in XLA. The reference's device preflight and
its bounded wait on the first result are TPU workarounds with no
counterpart here; the step's first run is synchronised.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from .ops.similarity import cosine_scores, normalize_rows
from .utils.device import resolve_device

N, D, B, K = 8192, 384, 32, 16


def search_step(corpus: torch.Tensor, queries: torch.Tensor,
                bias: torch.Tensor, last_accessed: torch.Tensor,
                access_count: torch.Tensor, kind_rates: torch.Tensor,
                now: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Embed-to-ranked-results step: (final scores [B, K] f32, corpus
    rows [B, K] int64), best first."""
    q = queries / queries.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    v, i = torch.topk(cosine_scores(corpus, q, bias), K, dim=1)
    idle_days = torch.clamp_min(now - last_accessed[i], 0.0) / 86400.0
    temporal = torch.clamp_min(
        torch.exp(-kind_rates[i] * torch.clamp_max(idle_days, 365.0)), 0.1)
    echo = torch.clamp_max(1.0 + access_count[i] * 0.05, 2.0)
    w = 0.15
    final = v * (1 - w) + v * temporal * echo * w
    order = torch.argsort(-final, dim=1, stable=True)
    return (torch.gather(final, 1, order), torch.gather(i, 1, order))


def entry(device="cuda") -> Tuple[Callable, tuple]:
    """Build the seeded inputs on `device`, run the step once and return
    (step, args): step(*args) is the search."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    corpus = normalize_rows(rng.normal(size=(N, D)).astype(np.float32))
    queries = rng.normal(size=(B, D)).astype(np.float32)
    last_accessed = rng.uniform(0, 1e6, size=N).astype(np.float32)
    access_count = rng.integers(0, 50, size=N).astype(np.float32)
    args = tuple(torch.as_tensor(a, device=dev) for a in (
        corpus, queries, np.zeros(N, np.float32), last_accessed,
        access_count, np.full(N, 0.02, np.float32),
        np.float32(1e6)))
    search_step(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return search_step, args

