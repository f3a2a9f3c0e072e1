"""Hybrid search: `HybridSearch` over the flat index and the graph
mirror of an in-memory store (`Cortex.in_memory`'s), the vector leg a
batch-1 flat search of 3 x the limit (K1, K2; the kind filter's bias
when the query has one), the proximity leg the mirror's packed host BFS
from each anchor, and the fusion with the nodes' hydration on the host."""

from __future__ import annotations

import sys
import time

# the rest of the systems interface is what the hybrid configurations share
from portbench.hybrid_search import (  # noqa: F401
    FETCH, HybridSystem, call, call_async, close, judge, make_data, ops,
    wait_ready)


def build(cfg: dict, data, dev):
    """The store's light nodes (title = id, empty body) and every edge
    through its raw bulk path, the flat index with every row inserted
    through the public API (the first search uploads it), and the graph
    mirror over the store (its first call builds the packed snapshot).
    Prints the split of the set-up to standard error."""
    from cortex_tpu_torch.graph.cache import AdjacencyCache
    from cortex_tpu_torch.graph.csr import DeviceGraphMirror
    from cortex_tpu_torch.storage import MemoryStorage
    from cortex_tpu_torch.types import EdgeProvenance
    from cortex_tpu_torch.vector.embedding import HashingEmbedder
    from cortex_tpu_torch.vector.hybrid import HybridSearch
    from cortex_tpu_torch.vector.index import TorchFlatIndex
    ids = data.ids
    t0 = time.perf_counter()
    storage = MemoryStorage()
    storage.bulk_insert_node_rows(
        (i, k, i, "") for i, k in zip(ids, data.kinds))
    t1 = time.perf_counter()
    prov = EdgeProvenance.imported(cfg["name"])
    edges = storage.bulk_insert_edge_rows(
        (f"e{j}", ids[s], ids[t], "related_to", 0.5, prov, 0.0, 0.0)
        for j, (s, t) in enumerate(zip(data.src.tolist(),
                                       data.dst.tolist())))
    t2 = time.perf_counter()
    p = cfg["index"]
    index = TorchFlatIndex(cfg["dim"], search_path=p["search_path"],
                           storage_dtype=p["storage_dtype"], device=dev)
    index.insert_batch(ids, data.rows, kinds=data.kinds)
    t3 = time.perf_counter()
    mirror = DeviceGraphMirror(AdjacencyCache(storage), storage=storage,
                               device=dev)
    hybrid = HybridSearch(storage, HashingEmbedder(cfg["dim"]), index,
                          mirror)
    print(f"hybrid build s: nodes {t1 - t0:.3f}, edges {t2 - t1:.3f} "
          f"({edges}), index insert {t3 - t2:.3f}", file=sys.stderr)
    return HybridSystem(hybrid=hybrid, edges=edges)


def least_work(cfg: dict, traffic: dict):
    """(bytes, int8 operations) the least a call needs, from the shapes
    alone: the flat index's at batch 1 and k = 3 x the limit (every live
    row's int8 code and float32 scale read once, the query, the fetched
    rows re-read in float32, their ids and scores written), plus the
    kind filter's float32 bias over the rows on the filtered share of
    calls; 2 N d operations. The proximity leg and the fusion run on the
    host and add nothing here."""
    n, d = cfg["rows"], cfg["dim"]
    k = FETCH * traffic["k"]
    nbytes = (n * (d + 4) + d * 4 + k * d * 4 + k * 8
              + 4 * n / traffic["filter_every"])
    return nbytes, 2 * n * d
