"""The IVF index: `TorchIvfIndex`, the probed lists scanned on the card
(`probed_scores`), the candidates widened through the kNN graph and
re-ranked exactly on the host."""

from __future__ import annotations

# the rest of the systems interface is what every search system shares
from portbench.vector_search import (  # noqa: F401
    call, call_async, close, judge, make_data, ops, wait_ready)


def build(cfg: dict, data, dev):
    """The index with the configuration's parameters (nlist, nprobe and
    the graph degree stated, no tuner), every row inserted through the
    public API (the first search trains and packs it and starts the
    graph's build)."""
    from cortex_tpu_torch.vector.ivf import TorchIvfIndex
    p = cfg["index"]
    index = TorchIvfIndex(cfg["dim"], nlist=p["nlist"], nprobe=p["nprobe"],
                          spill=p["spill"], graph_degree=p["graph_degree"],
                          target_recall=p["target_recall"], device=dev)
    index.insert_batch(data.ids, data.rows, kinds=data.kinds)
    return index


def least_work(cfg: dict, traffic: dict):
    """(bytes, int8 operations) the least a call needs, from the shapes
    alone: one query's nprobe lists of N / nlist rows (int8 code and
    float32 scale) read once, the B float32 queries read once, the k
    result rows of each query re-read in float32, and k ids and scores
    written; 2 B nprobe (N / nlist) d operations. A floor: at batch > 1
    the queries' lists overlap only in part."""
    n, d = cfg["rows"], cfg["dim"]
    b, k = traffic["batch"], traffic["k"]
    p = cfg["index"]
    probed = p["nprobe"] * n / p["nlist"]
    nbytes = probed * (d + 4) + b * d * 4 + b * k * d * 4 + b * k * 8
    return nbytes, 2 * b * probed * d
