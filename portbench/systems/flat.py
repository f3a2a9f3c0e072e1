"""The flat index: `TorchFlatIndex`, every search a scan of the whole
device corpus (K1's int8 candidates, then K2's exact fp32 re-rank)."""

from __future__ import annotations

# the rest of the systems interface is what every search system shares
from portbench.vector_search import (  # noqa: F401
    call, call_async, close, judge, make_data, ops, wait_ready)


def build(cfg: dict, data, dev):
    """The index with the configuration's parameters, every row
    inserted through the public API (the first search uploads it)."""
    from cortex_tpu_torch.vector.index import TorchFlatIndex
    p = cfg["index"]
    index = TorchFlatIndex(cfg["dim"], search_path=p["search_path"],
                           storage_dtype=p["storage_dtype"], device=dev)
    index.insert_batch(data.ids, data.rows, kinds=data.kinds)
    return index


def least_work(cfg: dict, traffic: dict):
    """(bytes, int8 operations) the least a call needs, from the shapes
    alone: every live row's int8 code and float32 scale read once, the B
    float32 queries read once, the k result rows of each query re-read
    in float32, and k ids and scores written; 2 B N d operations."""
    n, d = cfg["rows"], cfg["dim"]
    b, k = traffic["batch"], traffic["k"]
    nbytes = n * (d + 4) + b * d * 4 + b * k * d * 4 + b * k * 8
    return nbytes, 2 * b * n * d
