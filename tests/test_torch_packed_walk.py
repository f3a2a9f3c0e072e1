"""The packed tier's host walk (graph/csr.py::_sparse_walk) held to the
reference.

Above PACKED_EDGE_THRESHOLD edges the mirror walks each anchor over the
packed snapshot's CSR, touching only the rows it reaches, and builds the
depth map once a call. Here, on the CPU:

  * per_anchor in the packed tier equals the JAX mirror's on the same
    seeded graphs: hops 0 to 9 (clamped to HOP_CAP), one to four
    anchors with duplicates, an edge-less anchor, a soft-deleted one, a
    missing id and an empty list; HOST_FRONTIER_BUDGET just under, at
    and just over an anchor's reach, so the same anchors overflow to
    the device walk and packed_overflows agrees; one anchor on the
    device walk beside one on the host walk;
  * _sparse_walk equals PackedAdjacency.multi_bfs, budget check
    included, from every source of random graphs;
  * the mechanism: within the budget multi_bfs is never called,
    hybrid.host_walks counts the anchors the walk served, the scratch
    is all UNREACHED again after every walk, and concurrent callers get
    the reference's answers.
"""

import sys
import threading

import numpy as np
import pytest

from cortex_tpu_torch.graph import csr
from cortex_tpu_torch.graph.csr import _sparse_walk
from cortex_tpu_torch.graph.packed import UNREACHED, PackedAdjacency
from cortex_tpu_torch.utils import tracing
from test_torch_graph import (assert_per_anchor_equal, build_pair, mirrors,
                              port_graph)

PACKED = {"PACKED_EDGE_THRESHOLD": 0}


@pytest.fixture(scope="module")
def pair():
    """A denser graph than the tier tests' (300 nodes, ~1,200 edges and
    a hub), so 2- and 3-hop frontiers span many rows."""
    return build_pair(n=300, m=1200, seed=7, hub=5)


def anchor_sets(p):
    lonely, gone = p.ids[-1], p.ids[5]
    return {
        "one": [p.ids[0]],
        "two": [p.ids[2], p.ids[19]],
        "three": [p.ids[40], p.ids[41], p.ids[150]],
        "four": [p.ids[3], p.ids[77], p.ids[200], p.ids[299]],
        "duplicates": [p.ids[9], p.ids[9], p.ids[12], p.ids[9]],
        "edge_less": [lonely, p.ids[30]],
        "deleted": [gone, p.ids[31]],
        "missing": ["missing-id", p.ids[33], "missing-too"],
        "empty": [],
    }


CASES = ([("one", h) for h in (0, 1, 2, 3, 9)]
         + [(name, 2) for name in ("two", "three", "four", "duplicates",
                                   "edge_less", "deleted", "missing",
                                   "empty")]
         + [(name, 3) for name in ("three", "duplicates", "edge_less")])


@pytest.mark.parametrize("name,hops", CASES,
                         ids=[f"{n}-h{h}" for n, h in CASES])
def test_packed_per_anchor_matches_reference(pair, name, hops):
    ref, port = mirrors(pair, PACKED)
    anchors = anchor_sets(pair)[name]
    assert_per_anchor_equal(ref.per_anchor(anchors, hops),
                            port.per_anchor(anchors, hops))
    assert port.packed_overflows == ref.packed_overflows == 0


def reaches(p, anchors, hops):
    """The number of rows the packed host tier reaches from each anchor."""
    port = mirrors(p, PACKED)[1]
    return [len(port.per_anchor([a], hops)[1]) for a in anchors]


BUDGETS = [(d, cap) for d in (-1, 0, 1) for cap in (None, 4)]


@pytest.mark.parametrize("delta,out_cap", BUDGETS,
                         ids=[f"reach{d:+d}-cap{c}" for d, c in BUDGETS])
def test_budget_boundary_matches_reference(pair, delta, out_cap):
    """HOST_FRONTIER_BUDGET at an anchor's reach - 1 (it overflows to the
    device walk), = reach and + 1 (the host walk serves it); with
    PACKED_OUT_CAP 4 the device result fills its width and falls back to
    the exact host BFS, which packed_overflows counts."""
    a, hops = pair.ids[2], 2
    r, = reaches(pair, [a], hops)
    assert r > 4
    over = {**PACKED, "HOST_FRONTIER_BUDGET": r + delta}
    if out_cap is not None:
        over["PACKED_OUT_CAP"] = out_cap
    ref, port = mirrors(pair, over)
    for anchors in ([a], [a, a]):
        assert_per_anchor_equal(ref.per_anchor(anchors, hops),
                                port.per_anchor(anchors, hops))
    assert port.packed_overflows == ref.packed_overflows
    assert port.packed_overflows == (
        3 if delta < 0 and out_cap is not None else 0)


def split_budget(p, hops=2):
    """(small anchor, large anchor, budget) with the budget at the small
    anchor's reach, below the large one's."""
    r = dict(zip(p.ids[:60], reaches(p, p.ids[:60], hops)))
    by = sorted(r, key=r.get)
    small, large = by[len(by) // 3], by[-1]
    assert 1 < r[small] < r[large]
    return small, large, r[small]


@pytest.mark.parametrize("out_cap", [None, 4])
def test_host_and_device_walks_mix_like_reference(pair, out_cap):
    """One anchor within the budget (the host walk), one over it (the
    device walk, or with PACKED_OUT_CAP 4 its exact host fallback), in
    one call: the reference's map, and each walk counted once."""
    small, large, budget = split_budget(pair)
    over = {**PACKED, "HOST_FRONTIER_BUDGET": budget}
    if out_cap is not None:
        over["PACKED_OUT_CAP"] = out_cap
    ref, port = mirrors(pair, over)
    tracing.enable(True)
    tracing.reset_counters()
    try:
        for anchors in ([small, large], [large, small, "missing-id"]):
            assert_per_anchor_equal(ref.per_anchor(anchors, 2),
                                    port.per_anchor(anchors, 2))
        counts = tracing.counters()
    finally:
        tracing.enable(False)
        tracing.reset_counters()
    assert counts["hybrid.host_walks"] == 2
    assert counts["hybrid.device_walks"] == 2
    assert counts.get("hybrid.host_fallbacks", 0) == \
        port.packed_overflows == ref.packed_overflows == \
        (2 if out_cap is not None else 0)


WALKS = [(seed, hops) for seed in (1, 2, 3) for hops in (0, 1, 2, 4)]


@pytest.mark.parametrize("seed,hops", WALKS,
                         ids=[f"seed{s}-h{h}" for s, h in WALKS])
def test_sparse_walk_matches_multi_bfs(seed, hops):
    """From every source row, at budgets around its reach: None exactly
    where multi_bfs gives None, else the same rows at the same depths."""
    st, _ = port_graph(n_nodes=80, n_edges=260, seed=seed)
    pk = PackedAdjacency.build(st)
    seen = np.full(pk.n, UNREACHED, np.int8)
    for src in range(pk.n):
        dist = pk.multi_bfs([src], hops)
        r = int(np.count_nonzero(dist != UNREACHED))
        for budget in (r - 1, r, 10**9):
            want = pk.multi_bfs([src], hops, budget)
            got = _sparse_walk(pk, src, hops, budget, seen)
            assert (got is None) == (want is None)
            assert (seen == UNREACHED).all()
            if got is None:
                continue
            rows, depths = got
            assert depths.dtype == np.int32
            np.testing.assert_array_equal(np.sort(rows),
                                          np.nonzero(want != UNREACHED)[0])
            np.testing.assert_array_equal(depths, want[rows])
            assert (np.diff(depths) >= 0).all()


@pytest.mark.parametrize("fallback", [False, True],
                         ids=["within-budget", "device-fallback"])
def test_host_tier_never_calls_multi_bfs(pair, monkeypatch, fallback):
    """The packed tier runs no [n] pass: within the budget, and where
    the device result fills its width (PACKED_OUT_CAP 4) and the walk is
    redone on the host without a budget."""
    over = dict(PACKED)
    if fallback:
        over.update(HOST_FRONTIER_BUDGET=1, PACKED_OUT_CAP=4)
    ref, port = mirrors(pair, over)
    sets = anchor_sets(pair)
    want = {name: ref.per_anchor(a, 3) for name, a in sets.items()}

    def dense(*a, **kw):
        raise AssertionError("multi_bfs called by the packed tier")
    monkeypatch.setattr(PackedAdjacency, "multi_bfs", dense)
    for name, anchors in sets.items():
        assert_per_anchor_equal(want[name], port.per_anchor(anchors, 3))
    assert port.packed_overflows == ref.packed_overflows
    assert (port.packed_overflows > 0) == fallback


def test_host_walks_count_anchors_served(pair):
    _, port = mirrors(pair, PACKED)
    sets = anchor_sets(pair)
    tracing.enable(True)
    tracing.reset_counters()
    try:
        served = 0
        for anchors in sets.values():
            served += len(port.per_anchor(anchors, 2)[0])
        counts = tracing.counters()
    finally:
        tracing.enable(False)
        tracing.reset_counters()
    assert served > 10
    assert counts["hybrid.host_walks"] == served
    assert "hybrid.device_walks" not in counts


def test_scratch_is_left_unreached(pair):
    """After walks within the budget and after one that overflows, the
    snapshot's pooled scratch holds UNREACHED in every entry."""
    small, large, budget = split_budget(pair)
    _, port = mirrors(pair, {**PACKED, "HOST_FRONTIER_BUDGET": budget})
    pk = port._ensure_packed()
    for anchors, hops in (([small], 2), ([large, small], 2),
                          ([large], 3), ([small, large, small], 9)):
        port.per_anchor(anchors, hops)
        assert len(pk._host_scratch) == 1
        scratch = pk._host_scratch[0]
        assert scratch.shape == (pk.n,) and scratch.dtype == np.int8
        assert (scratch == UNREACHED).all()


def test_scratch_returns_to_pool_when_device_walk_raises(pair,
                                                        monkeypatch):
    """An anchor over the budget whose device walk raises: the call
    raises, and the scratch it held is back in the pool, all UNREACHED."""
    small, large, budget = split_budget(pair)
    _, port = mirrors(pair, {**PACKED, "HOST_FRONTIER_BUDGET": budget})
    pk = port._ensure_packed()
    port.per_anchor([small], 2)
    scratch = pk._host_scratch[0]

    def broken(*a, **kw):
        raise RuntimeError("device walk failed")
    monkeypatch.setattr(csr, "frontier_bfs_compact", broken)
    with pytest.raises(RuntimeError, match="device walk failed"):
        port.per_anchor([small, large], 2)
    assert len(pk._host_scratch) == 1
    assert pk._host_scratch[0] is scratch
    assert (scratch == UNREACHED).all()


def test_concurrent_callers_match_reference(pair):
    """Two threads, 200 calls each on one snapshot, with a short switch
    interval: every answer is the reference's."""
    ref, port = mirrors(pair, PACKED)
    sets = [a for a in anchor_sets(pair).values() if a]
    want = [ref.per_anchor(a, 3) for a in sets]
    port._ensure_packed()
    errors = []

    def worker(offset):
        try:
            for i in range(200):
                k = (i + offset) % len(sets)
                assert_per_anchor_equal(want[k], port.per_anchor(sets[k], 3))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(o,))
                   for o in (0, 3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    pool = port._ensure_packed()._host_scratch
    assert 1 <= len(pool) <= 2
    assert all((s == UNREACHED).all() for s in pool)
