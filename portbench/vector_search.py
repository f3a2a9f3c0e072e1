"""What the vector-search configurations share: their inputs, the entry
the window drives, the wait for a ready index, and the comparison with
the plain reference that decides `correct`.

One operation is one search query. A configuration's systems module
(systems/flat.py, systems/ivf.py) adds how its index is built and the
least work of a call.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import reference
from .verdict import Verdict
from .data import clustered_rows, noisy_centers

#: the longest a set-up waits for an index's background work (the IVF
#: kNN graph) before it gives up
READY_TIMEOUT_S = 600


@dataclass
class SearchData:
    """The benchmark's own inputs, on the host: what the program gets and
    what the reference reads."""

    rows: np.ndarray                  # [N, d] float32 unit rows
    ids: List[str]                    # row r is id str(r)
    kinds: List[str]
    pool: np.ndarray                  # [P, d] float32 unit queries
    batches: List[np.ndarray]         # pool[s:s + batch], cycled by calls


def make_data(cfg: dict, traffic: dict, seed: int,
              dev: torch.device) -> SearchData:
    """The configuration's rows and the traffic's query pool, drawn on dev
    from one generator seeded with `seed`."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    x, centers = clustered_rows(gen, dev, cfg["rows"], cfg["dim"],
                                groups=cfg["centers"], spread=cfg["spread"])
    rows = x.cpu().numpy()
    del x
    pool = noisy_centers(gen, centers, traffic["pool"],
                         spread=cfg["query_spread"])
    b = traffic["batch"]
    if len(pool) % b:
        raise ValueError(f"pool {len(pool)} is no multiple of batch {b}")
    n = cfg["rows"]
    return SearchData(
        rows=rows, ids=[str(r) for r in range(n)],
        kinds=[f"k{r % cfg['kinds']}" for r in range(n)], pool=pool,
        batches=[pool[s:s + b] for s in range(0, len(pool), b)])


def call(index, batch: np.ndarray, traffic: dict):
    """One timed search: the hits of every query of the batch."""
    return index.search_batch(batch, traffic["k"], refine=traffic["refine"])


def call_async(index, batch: np.ndarray, traffic: dict):
    """The same search split in two: dispatch now, and the returned
    callable that yields the hits."""
    return index.search_batch_async(batch, traffic["k"],
                                    refine=traffic["refine"])


def ops(batch: np.ndarray) -> int:
    return len(batch)


def wait_ready(index, cfg: dict) -> dict:
    """Wait for the index's background work (the IVF kNN graph) and check
    that it serves as the configuration states (`expect_info`, a subset
    of index_info()). Raises when it does not: such a run is no sound
    run of the configuration."""
    deadline = time.monotonic() + READY_TIMEOUT_S
    while True:
        info = index.index_info()
        if info.get("graph_error"):
            raise RuntimeError(f"the kNN graph failed: {info['graph_error']}")
        if info.get("graph_built", True) or not info.get("graph_degree"):
            break
        if time.monotonic() > deadline:
            raise RuntimeError("the kNN graph did not swap in within "
                               f"{READY_TIMEOUT_S} s")
        time.sleep(0.05)
    for key, want in cfg.get("expect_info", {}).items():
        if info.get(key) != want:
            raise RuntimeError(f"index_info()[{key!r}] is {info.get(key)!r}"
                               f", the configuration states {want!r}")
    return info


def close(index) -> None:
    index.close()


def _parse(hits, k: int, n: int):
    """(rows, scores) of one query's hits, or None when the answer is
    malformed: not k hits, an id that names no row, or an id twice."""
    if len(hits) != k:
        return None
    try:
        rows = [int(i) for i, _ in hits]
    except (TypeError, ValueError):
        return None
    if len(set(rows)) != k or min(rows) < 0 or max(rows) >= n:
        return None
    return rows, [float(s) for _, s in hits]


def judge(cfg: dict, traffic: dict, data: SearchData, outputs,
          dev: torch.device) -> Verdict:
    """Compare every answer the window returned with the reference.

    outputs: (batch number, hits or None for a call that raised) per call.
    Identical answers to one query are compared once and counted as
    often as they came. Compared numbers:
      score_gap  the largest |returned score - the reference's fp32
                 cosine of that query and row| (every configuration);
      rank_gap   the largest distance by which a returned row's
                 reference score lies below the reference's k-th best
                 (an exact top-k);
      recall     the mean share of the reference's top k returned, a
                 failed query counting 0 (an approximate top-k; its
                 configuration states the floor).
    A query whose answer is missing or malformed is failed."""
    k, b, n = traffic["k"], traffic["batch"], cfg["rows"]
    seen: Dict[tuple, List] = {}
    attempted = failed = 0
    for batch_no, hits in outputs:
        attempted += b
        if hits is None or len(hits) != b:
            failed += b
            continue
        key = (batch_no, tuple(tuple(h) for h in hits))
        if key in seen:
            seen[key][0] += 1
        else:
            seen[key] = [1, hits]
    qidx, ridx, got, cnt = [], [], [], []
    for (batch_no, _), (count, hits) in seen.items():
        for j, h in enumerate(hits):
            parsed = _parse(h, k, n)
            if parsed is None:
                failed += count
                continue
            qidx.append(batch_no * b + j)
            ridx.append(parsed[0])
            got.append(parsed[1])
            cnt.append(count)
    limits = cfg["limits"]
    guarantee = cfg["guarantee"]["kind"]
    checks = {"failed": (failed, "<=", 0)}
    if not qidx:
        checks.update({name: (None, op, lim) for name, (op, lim) in
                       _limit_ops(guarantee, limits).items()})
        return Verdict(attempted, failed, checks, {"recall": 0.0})
    qidx = np.asarray(qidx, np.int64)
    ridx = np.asarray(ridx, np.int64)
    got = np.asarray(got, np.float32)
    cnt = np.asarray(cnt, np.int64)
    _, ref_i = reference.exact_topk(data.rows, data.pool, k, dev)
    pair = reference.pair_scores(data.rows, data.pool, qidx, ridx, dev)
    # the reference's k-th best scored as the returned rows are, so that
    # an answer equal to the reference's reads 0
    ref_kth = reference.pair_scores(data.rows, data.pool, qidx,
                                    ref_i[qidx], dev).min(1)
    hit = (ridx[:, :, None] == ref_i[qidx][:, None, :]).any(2).sum(1) / k
    values = {
        "score_gap": float(np.abs(got - pair).max()),
        "rank_gap": float(max(0.0, (ref_kth - pair.min(1)).max())),
        "recall": float((hit * cnt).sum() / max(1, attempted)),
        "distinct_answers": len(qidx),
    }
    checks.update({name: (values[name], op, lim) for name, (op, lim) in
                   _limit_ops(guarantee, limits).items()})
    return Verdict(attempted, failed, checks, values)


def _limit_ops(guarantee: str, limits: dict) -> Dict[str, Tuple[str, float]]:
    """The numbers a guarantee compares, each with its direction and
    limit."""
    if guarantee == "exact_topk":
        return {"score_gap": ("<=", limits["score_gap"]),
                "rank_gap": ("<=", limits["rank_gap"])}
    if guarantee == "approximate_topk":
        return {"score_gap": ("<=", limits["score_gap"]),
                "recall": (">=", limits["recall"])}
    raise ValueError(f"unknown guarantee {guarantee!r}")
