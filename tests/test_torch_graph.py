"""The port's graph slice held against cortex_tpu on the same graphs.

cortex_tpu_torch keeps copies of the reference's graph engine (types,
subgraph, cache, traversal, paths, host_csr, engine, packed) and of its
native BFS and components; its device mirror (graph/csr.py) runs on
torch. Here:

  * the copies agree with the reference line for line but for imports,
    and the native C++ functions character for character;
  * the engine (traverse, paths, analytics, components) returns what the
    reference returns on the same seeded graphs (same node ids), with
    and without the native library;
  * the mirror's tiers, each reached with the instance overrides the
    reference's own tests use (host BFS; object-cache relaxation, G2 in
    per_anchor and G1 in depths_from; G1 overflowing into G2; packed
    host BFS; packed device walk; packed walk whose compaction fills),
    return what the reference's do: per_anchor, depths_from,
    proximity_scores and batch_graph_scores, exactly;
  * the randomized checks of tests/test_packed_adjacency.py and
    tests/test_graph.py::TestDeviceMirror, run on the port;
  * state carried across: a SQLite file with nodes and edges, written
    by the reference, opens in the port, whose mirror then builds the
    reference's neighbor table element for element, the same row map
    and the same packed snapshot. The graph's state is its edge store,
    so the shared file format is the carry-over.

The port runs on the CPU (device="cpu": the kernels' plain versions);
the reference's XLA programs run on JAX's CPU backend.
"""

import re
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import cortex_tpu.graph as jg
from cortex_tpu import native as jax_native
from cortex_tpu.graph import DeviceGraphMirror as JaxMirror
from cortex_tpu.graph import GraphEngine as JaxEngine
from cortex_tpu.graph.cache import AdjacencyCache as JaxCache
from cortex_tpu.graph.packed import PackedAdjacency as JaxPacked
from cortex_tpu.storage import MemoryStorage as JaxMemory
from cortex_tpu.storage import SqliteStorage as JaxSqlite
from cortex_tpu.types import Edge as JaxEdge
from cortex_tpu.types import EdgeProvenance as JaxProv
from cortex_tpu.types import Node as JaxNode
from cortex_tpu.types import Source as JaxSource
from cortex_tpu_torch import native as torch_native
from cortex_tpu_torch.graph import (BOTH, DFS, INCOMING, OUTGOING,
                                    WEIGHTED, DeviceGraphMirror,
                                    GraphEngine, PathRequest,
                                    TraversalBudget, TraversalRequest)
from cortex_tpu_torch.graph.cache import AdjacencyCache
from cortex_tpu_torch.graph.packed import UNREACHED, PackedAdjacency
from cortex_tpu_torch.ops import graph_bfs
from cortex_tpu_torch.storage import MemoryStorage
from cortex_tpu_torch.storage import SqliteStorage
from cortex_tpu_torch.types import Edge, EdgeProvenance, Node, Source

REPO = Path(__file__).resolve().parent.parent
COPIES = ("graph/__init__.py", "graph/types.py", "graph/subgraph.py",
          "graph/cache.py", "graph/traversal.py", "graph/paths.py",
          "graph/host_csr.py", "graph/engine.py", "graph/packed.py")
KINDS = ("fact", "event", "decision")
RELATIONS = ("related_to", "led_to", "uses")


def _without_imports(text):
    return [line for line in text.splitlines()
            if not re.match(r"\s*(from|import)\s", line)]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_matches_reference(rel):
    ref = (REPO / "cortex_tpu" / rel).read_text()
    port = (REPO / "cortex_tpu_torch" / rel).read_text()
    assert _without_imports(port) == _without_imports(ref)


def _c_function(text, signature):
    start = text.index(signature)
    return text[start:text.index("\n}\n", start) + 3]


@pytest.mark.parametrize("fn", ["int64_t gc_bfs(", "int32_t gc_components("])
def test_native_graph_functions_match_reference(fn):
    ref = (REPO / "cortex_tpu/native/graphcore.cpp").read_text()
    port = (REPO / "cortex_tpu_torch/native/host_graph.cpp").read_text()
    assert _c_function(port, fn) == _c_function(ref, fn)


# ------------------------------------------------------------ graphs


class Pair:
    """One seeded graph in a reference store and a port store, with the
    same node and edge ids."""

    def __init__(self, ref_st, port_st):
        self.ref_st, self.port_st = ref_st, port_st
        self.ids, self.edges = [], []

    def node(self, i, kind):
        node = JaxNode.new(kind, f"graph node {i}", f"body of node {i}",
                           JaxSource(agent="t"))
        self.ref_st.put_node(node)
        self.port_st.put_node(Node.from_dict(node.to_dict()))
        self.ids.append(node.id)
        return node.id

    def edge(self, a, b, relation, weight):
        e = JaxEdge.new(a, b, relation, weight, JaxProv.manual("t"))
        self.ref_st.put_edge(e)
        self.port_st.put_edge(Edge.from_dict(e.to_dict()))
        self.edges.append(e.id)
        return e.id


def build_pair(n=60, m=150, seed=0, *, ref_st=None, port_st=None,
               hub=0, deleted=2, lonely=2):
    """n nodes of mixed kinds, ~m distinct directed edges (mixed
    relations, weights in [0.1, 1]), a hub with `hub` extra neighbours,
    `deleted` soft-deleted nodes (their edges stay) and `lonely` nodes
    without edges."""
    p = Pair(ref_st if ref_st is not None else JaxMemory(),
             port_st if port_st is not None else MemoryStorage())
    rng = np.random.default_rng(seed)
    for i in range(n):
        p.node(i, KINDS[i % len(KINDS)])
    made = set()
    for _ in range(m):
        a, b = (int(x) for x in rng.integers(0, n, 2))
        if a == b or (a, b) in made:
            continue
        made.add((a, b))
        p.edge(p.ids[a], p.ids[b], RELATIONS[int(rng.integers(0, 3))],
               float(np.round(rng.uniform(0.1, 1.0), 3)))
    for j in range(hub):
        leaf = p.node(n + j, "fact")
        p.edge(p.ids[0], leaf, "related_to", 0.5)
    for nid in p.ids[5:5 + deleted]:
        p.ref_st.delete_node(nid)
        p.port_st.delete_node(nid)
    for j in range(lonely):
        p.node(n + hub + j, "event")
    return p


def sub_key(sub):
    return (list(sub.nodes), sub.depths, [e.id for e in sub.edges],
            sub.visited_count, sub.truncated)


@pytest.fixture(params=["native", "python"])
def engines(request, monkeypatch):
    if request.param == "python":
        monkeypatch.setattr(jax_native, "available", lambda: False)
        monkeypatch.setattr(torch_native, "available", lambda: False)
    else:
        assert jax_native.available() and torch_native.available()
    p = build_pair(seed=3)
    budget = TraversalBudget(max_visited=40, max_nodes_per_level=12)
    return (JaxEngine(p.ref_st), GraphEngine(p.port_st),
            JaxEngine(p.ref_st, budget), GraphEngine(p.port_st, budget), p)


TRAVERSALS = [
    dict(max_depth=1), dict(max_depth=3), dict(max_depth=None),
    dict(direction=INCOMING), dict(direction=BOTH, max_depth=2),
    dict(strategy=DFS, max_depth=4), dict(strategy=WEIGHTED, max_depth=3),
    dict(strategy=WEIGHTED, direction=BOTH, limit=7),
    dict(direction=BOTH, kind_filter=["event"]),
    dict(relation_filter=["led_to", "uses"], direction=BOTH),
    dict(min_weight=0.5, direction=BOTH), dict(limit=5, direction=BOTH),
    dict(include_start=False, direction=BOTH),
]


@pytest.mark.parametrize("kw", TRAVERSALS, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_traverse_matches_reference(engines, kw):
    ref, port, ref_b, port_b, p = engines
    for starts in ([p.ids[0]], [p.ids[3], p.ids[11]], [p.ids[5]]):
        for r, t in ((ref, port), (ref_b, port_b)):
            want = r.traverse(jg.TraversalRequest(start=starts, **kw))
            got = t.traverse(TraversalRequest(start=starts, **kw))
            assert sub_key(got) == sub_key(want)


PATHS = [dict(), dict(max_length=2), dict(max_length=0),
         dict(max_paths=3), dict(min_weight=0.3),
         dict(min_weight=0.2, max_paths=3),
         dict(relation_filter=["related_to", "led_to"])]


@pytest.mark.parametrize("kw", PATHS, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()) or "plain")
def test_find_paths_matches_reference(engines, kw):
    ref, port, _, _, p = engines
    pairs = [(p.ids[i], p.ids[j]) for i, j in
             ((0, 1), (2, 40), (9, 9), (4, 5), (13, 52), (20, 61))]
    for a, b in pairs:
        want = ref.find_paths(jg.PathRequest(from_id=a, to_id=b, **kw))
        got = port.find_paths(PathRequest(from_id=a, to_id=b, **kw))
        # Yen's candidates tie-break on id(nodes), a memory address
        # (graph/paths.py:187, both packages): past the first path, the
        # order among equally long and heavy paths is not fixed
        assert [(x.nodes, x.edges, x.total_weight)
                for x in got.paths[:1]] == \
            [(x.nodes, x.edges, x.total_weight) for x in want.paths[:1]]
        assert sorted((len(x.edges), x.total_weight) for x in got.paths) \
            == sorted((len(x.edges), x.total_weight) for x in want.paths)


def test_analytics_match_reference(engines):
    ref, port, _, _, p = engines
    for nid in p.ids[:12]:
        for direction in (OUTGOING, INCOMING, BOTH):
            assert port.neighbors(nid, direction) == \
                ref.neighbors(nid, direction)
        assert [(x.node_id, x.depth) for x in port.neighborhood(nid, 2)] \
            == [(x.node_id, x.depth) for x in ref.neighborhood(nid, 2)]
        assert port.reachable(nid, p.ids[30], 3) == \
            ref.reachable(nid, p.ids[30], 3)
    assert port.roots() == ref.roots()
    assert port.leaves() == ref.leaves()
    assert port.most_connected(7) == ref.most_connected(7)
    assert port.find_cycles(20) == ref.find_cycles(20)
    assert port.components() == ref.components()


# --------------------------------------------------- the mirror's tiers


TIERS = {
    "host": {},
    "object_relax": {"HOST_FRONTIER_BUDGET": 0},
    "walk_overflow": {"HOST_FRONTIER_BUDGET": 0, "DEVICE_FRONTIER_CAP": 1},
    "packed_host": {"PACKED_EDGE_THRESHOLD": 0},
    "packed_walk": {"PACKED_EDGE_THRESHOLD": 0, "HOST_FRONTIER_BUDGET": 0},
    "packed_out_cap": {"PACKED_EDGE_THRESHOLD": 0,
                       "HOST_FRONTIER_BUDGET": 0, "PACKED_OUT_CAP": 4},
}


def mirrors(p, overrides):
    ref = JaxMirror(JaxCache(p.ref_st))
    port = DeviceGraphMirror(AdjacencyCache(p.port_st), device="cpu")
    for m in (ref, port):
        for k, v in overrides.items():
            setattr(m, k, v)
    return ref, port


def assert_per_anchor_equal(want, got):
    assert got[0] == want[0]
    assert set(got[1]) == set(want[1])
    for k, v in want[1].items():
        np.testing.assert_array_equal(got[1][k], v)
        assert got[1][k].dtype == np.int32


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("seed", [0, 1])
def test_mirror_tier_matches_reference(tier, seed):
    p = build_pair(seed=seed, hub=3)
    ref, port = mirrors(p, TIERS[tier])
    lonely, gone = p.ids[-1], p.ids[5]
    anchor_sets = [[p.ids[0]], [p.ids[2], p.ids[19]],
                   [p.ids[4], lonely, "missing-id", gone], []]
    for i, anchors in enumerate(anchor_sets):
        for hops in ((1, 3, 9) if i == 0 else (3,)):
            assert_per_anchor_equal(ref.per_anchor(anchors, hops),
                                    port.per_anchor(anchors, hops))
            assert port.per_anchor_depths(anchors, hops).keys() == \
                ref.per_anchor_depths(anchors, hops).keys()
            assert port.depths_from(anchors, hops) == \
                ref.depths_from(anchors, hops)
            assert port.proximity_scores(anchors, hops) == \
                ref.proximity_scores(anchors, hops)
            cands = [[p.ids[1], None, "missing-id", p.ids[22]],
                     p.ids[30:36], []]
            np.testing.assert_array_equal(
                port.batch_graph_scores(anchors, hops, cands),
                ref.batch_graph_scores(anchors, hops, cands))
    assert port.anchor_row_ids(anchor_sets[2]) == \
        ref.anchor_row_ids(anchor_sets[2])
    assert port.packed_overflows == ref.packed_overflows
    assert port.truncated_nodes == ref.truncated_nodes


@pytest.mark.parametrize("seed", [0, 3])
def test_packed_walk_width_boundary_matches_reference(seed):
    """The packed device walk with PACKED_OUT_CAP just under, at and just
    over an anchor's reached count: the same per_anchor output as the
    reference's, and the same fall-backs counted in packed_overflows
    (the walk's exact count takes the place of the compaction's)."""
    p = build_pair(seed=seed, hub=3)
    anchors = [p.ids[0], p.ids[2]]
    host = mirrors(p, {"PACKED_EDGE_THRESHOLD": 0})[1]
    reach = max(len(host.per_anchor([a], 2)[1]) for a in anchors)
    assert reach > 2
    for out_cap, falls in ((reach - 1, 1), (reach, 1), (reach + 1, 0)):
        ref, port = mirrors(p, {**TIERS["packed_walk"],
                                "PACKED_OUT_CAP": out_cap})
        for a in anchors:
            assert_per_anchor_equal(ref.per_anchor([a], 2),
                                    port.per_anchor([a], 2))
        assert port.packed_overflows == ref.packed_overflows >= falls


@pytest.mark.parametrize("tier,kernels", [
    ("host", set()), ("object_relax", {"frontier_bfs", "bfs_relax"}),
    ("walk_overflow", {"frontier_bfs", "bfs_relax"}),
    ("packed_host", set()),
    ("packed_walk", {"frontier_bfs_compact", "frontier_bfs"})])
def test_each_tier_reaches_its_kernels(tier, kernels, monkeypatch):
    """Which kernel wrappers each tier calls (on the CPU they run the
    plain versions): per_anchor's packed walk is the compact walk, and
    depths_from walks the object-cache table."""
    seen = set()
    for name in ("frontier_bfs", "frontier_bfs_compact", "bfs_relax"):
        real = getattr(graph_bfs, name)

        def spy(*a, _real=real, _name=name, **kw):
            seen.add(_name)
            return _real(*a, **kw)
        # csr.py's own names, and graph_bfs's
        monkeypatch.setattr("cortex_tpu_torch.graph.csr." + name, spy)
        monkeypatch.setattr(graph_bfs, name, spy)
    p = build_pair(seed=4)
    _, port = mirrors(p, TIERS[tier])
    port.per_anchor([p.ids[0], p.ids[8]], 3)
    port.depths_from([p.ids[0]], 3)
    assert seen == kernels


def test_hub_truncation_matches_reference():
    """A hub wider than the table's 64 columns: the object and packed
    tables truncate it alike in both packages, and every tier still
    matches the reference."""
    p = build_pair(seed=6, n=40, m=60, hub=80)
    for tier in ("object_relax", "packed_walk", "packed_host"):
        ref, port = mirrors(p, TIERS[tier])
        for hops in (1, 2):
            assert_per_anchor_equal(ref.per_anchor([p.ids[0]], hops),
                                    port.per_anchor([p.ids[0]], hops))
        assert port.truncated_nodes == ref.truncated_nodes == \
            (tier != "packed_host")
    ref, port = mirrors(p, {})
    ref.ensure()
    port.ensure()
    np.testing.assert_array_equal(port._nbrs.numpy(), np.asarray(ref._nbrs))


# ------------------------------------- the reference's randomized checks


def port_graph(n_nodes=60, n_edges=150, seed=0):
    """tests/test_packed_adjacency.py::build_graph in the port."""
    st = MemoryStorage()
    rng = np.random.default_rng(seed)
    ids = []
    for i in range(n_nodes):
        node = Node.new("fact", f"packed test node {i}", f"body {i}",
                        Source(agent="t"))
        st.put_node(node)
        ids.append(node.id)
    made = set()
    for _ in range(n_edges):
        a, b = rng.integers(0, n_nodes, 2)
        if a == b or (a, b) in made:
            continue
        made.add((int(a), int(b)))
        st.put_edge(Edge.new(ids[a], ids[b], "related_to", 0.5,
                             EdgeProvenance.manual("t")))
    return st, ids


def cpu_mirror(st, **overrides):
    m = DeviceGraphMirror(AdjacencyCache(st), device="cpu")
    for k, v in overrides.items():
        setattr(m, k, v)
    return m


@pytest.mark.parametrize("seed", [0, 4, 8])
def test_packed_build_matches_object_cache(seed):
    st, ids = port_graph(seed=seed)
    pk = PackedAdjacency.build(st)
    cache = AdjacencyCache(st)
    for nid in ids:
        want = {a.neighbor for a in cache.outgoing(nid)} \
            | {a.neighbor for a in cache.incoming(nid)}
        if nid not in pk.row_of:
            assert not want
            continue
        r = pk.row_of[nid]
        assert {pk.ids[j] for j in
                pk.indices[pk.indptr[r]:pk.indptr[r + 1]]} == want


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_packed_multi_bfs_matches_host_bfs(seed):
    st, ids = port_graph(seed=seed)
    pk = PackedAdjacency.build(st)
    mirror = cpu_mirror(st)
    anchors = [ids[0], ids[7], ids[13]]
    for hops in (1, 2, 4):
        want = mirror._host_multi_bfs(anchors, hops, 10**9)
        dist = pk.multi_bfs([pk.row_of[a] for a in anchors
                             if a in pk.row_of], hops)
        got = {pk.ids[i]: int(d) for i, d in enumerate(dist)
               if d != UNREACHED}
        assert got == {k: v for k, v in want.items() if k in pk.row_of}


@pytest.mark.parametrize("seed", [9, 10])
def test_packed_neighbor_table_matches_mirror(seed):
    st, ids = port_graph(seed=seed)
    pk = PackedAdjacency.build(st)
    mirror = cpu_mirror(st)
    mirror.ensure()
    nbrs, trunc = pk.neighbor_table(mirror._max_deg)
    assert trunc == mirror.truncated_nodes == 0
    mnbrs = mirror._nbrs.numpy()
    for nid, r in pk.row_of.items():
        mr = mirror._row_of[nid]
        assert {pk.ids[int(x)] for x in nbrs[r] if x >= 0} == \
            {mirror._id_of[int(x)] for x in mnbrs[mr] if x >= 0}


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_packed_routes_match_object_routes(seed):
    """per_anchor_depths: the packed host tier and the packed device
    walk both equal the object-cache tier (no hub truncation)."""
    st, ids = port_graph(seed=seed)
    anchors = [ids[2], ids[19], ids[30]]
    want = cpu_mirror(st).per_anchor_depths(anchors, 3)
    packed = cpu_mirror(st, PACKED_EDGE_THRESHOLD=0)
    universe = packed._ensure_packed().row_of
    want = {k: v for k, v in want.items() if k in universe}
    for m in (packed, cpu_mirror(st, PACKED_EDGE_THRESHOLD=0,
                                 HOST_FRONTIER_BUDGET=0)):
        got = m.per_anchor_depths(anchors, 3)
        assert m.truncated_nodes == 0
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_packed_membership_and_budget():
    st, ids = port_graph(n_nodes=40, n_edges=300, seed=5)
    pk = PackedAdjacency.build(st)
    assert pk.multi_bfs([pk.row_of[ids[0]]], 4, budget=3) is None
    assert PackedAdjacency.build(MemoryStorage()).multi_bfs([], 3) \
        is not None
    packed = cpu_mirror(st, PACKED_EDGE_THRESHOLD=0)
    lonely = Node.new("fact", "edge-less loner node",
                      "no edges attach here", Source(agent="t"))
    st.put_node(lonely)
    linked = [i for i in ids if i in packed._ensure_packed().row_of]
    assert packed._in_graph(linked[0])
    assert not packed._in_graph(lonely.id)
    assert packed.anchor_row_ids([lonely.id, linked[0]]) == [linked[0]]


def _wait_swap(m, old):
    deadline = time.monotonic() + 10
    while m._packed is old and time.monotonic() < deadline:
        time.sleep(0.02)


def test_packed_rebuild_debounce_and_snapshot_tables():
    """Within REBUILD_MIN_S the stale snapshot serves; past it the
    tripping call still serves it while the rebuild runs in the
    background; the device table caches on each snapshot."""
    st, ids = port_graph(seed=17)
    m = cpu_mirror(st, PACKED_EDGE_THRESHOLD=0)
    pk1 = m._ensure_packed()
    t1 = m._packed_device_nbrs(pk1)
    st.put_edge(Edge.new(ids[0], ids[1], "supersedes", 0.9,
                         EdgeProvenance.manual("t")))
    m._cache.invalidate()
    assert m._ensure_packed() is pk1
    m.REBUILD_MIN_S = 0.0
    assert m._ensure_packed() is pk1
    _wait_swap(m, pk1)
    pk2 = m._ensure_packed()
    assert pk2 is not pk1 and m.packed_rebuilds == 2
    r = pk2.row_of[ids[0]]
    assert pk2.row_of[ids[1]] in set(
        pk2.indices[pk2.indptr[r]:pk2.indptr[r + 1]].tolist())
    t2 = m._packed_device_nbrs(pk2)
    assert t2 is not t1 and m._packed_device_nbrs(pk1) is t1
    assert isinstance(t2, torch.Tensor) and t2.device.type == "cpu"
    stable = cpu_mirror(st, PACKED_EDGE_THRESHOLD=0, REBUILD_MIN_S=0.0)
    first = stable._ensure_packed()
    assert stable._ensure_packed() is first and stable.packed_rebuilds == 1


def test_packed_rebuild_never_blocks_readers(monkeypatch):
    st, ids = port_graph(seed=21)
    m = cpu_mirror(st, PACKED_EDGE_THRESHOLD=0)
    pk1 = m._ensure_packed()
    m.REBUILD_MIN_S = 0.0
    m._cache.invalidate()
    real_build = PackedAdjacency.build
    entered, release = threading.Event(), threading.Event()

    def slow_build(storage, chunk=1_000_000):
        entered.set()
        release.wait(timeout=10)
        return real_build(storage, chunk)

    monkeypatch.setattr(PackedAdjacency, "build", staticmethod(slow_build))
    t0 = time.monotonic()
    assert m._ensure_packed() is pk1
    assert entered.wait(timeout=5)
    assert m._ensure_packed() is pk1
    assert time.monotonic() - t0 < 5.0
    release.set()
    _wait_swap(m, pk1)
    assert m._packed is not pk1


def test_packed_out_cap_fill_falls_back_to_exact():
    st, ids = port_graph(seed=25)
    want = cpu_mirror(st, PACKED_EDGE_THRESHOLD=0).per_anchor_depths(
        [ids[3]], 3)
    forced = cpu_mirror(st, PACKED_EDGE_THRESHOLD=0, HOST_FRONTIER_BUDGET=0,
                        PACKED_OUT_CAP=4)
    got = forced.per_anchor_depths([ids[3]], 3)
    assert forced.packed_overflows >= 1
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_packed_build_failure_degrades_and_backs_off():
    st, ids = port_graph(seed=27)
    m = cpu_mirror(st, PACKED_EDGE_THRESHOLD=0)
    calls = {"n": 0}
    real = st.edge_endpoints

    def boom(chunk=1_000_000):
        calls["n"] += 1
        raise OSError("storage io error (test)")

    st.edge_endpoints = boom
    assert m.per_anchor_depths([ids[0]], 3) == {}
    assert m._in_graph(ids[0]) is False
    assert m.per_anchor_depths([ids[0]], 3) == {} and calls["n"] == 1
    m._build_backoff_until = 0.0
    st.edge_endpoints = real
    assert m.per_anchor_depths([ids[0]], 3)


def chain(st, n):
    nodes = [Node.new("fact", f"Chain node {i}", f"Body of chain node {i}",
                      Source(agent="t")) for i in range(n)]
    for nd in nodes:
        st.put_node(nd)
    for i in range(n - 1):
        st.put_edge(Edge.new(nodes[i].id, nodes[i + 1].id, "led_to", 0.8,
                             EdgeProvenance.manual("t")))
    return [nd.id for nd in nodes]


@pytest.mark.parametrize("budget", [None, 0])
def test_device_mirror_chain_depths(budget):
    """tests/test_graph.py::TestDeviceMirror on the port, on the host
    tier and (budget 0) on the device tiers."""
    st = MemoryStorage()
    ids = chain(st, 6)
    kw = {} if budget is None else {"HOST_FRONTIER_BUDGET": budget}
    m = cpu_mirror(st, **kw)
    depths = m.depths_from([ids[0]], 3)
    assert [depths[i] for i in ids[:4]] == [0, 1, 2, 3]
    assert ids[4] not in depths
    two = m.depths_from([ids[0], ids[5]], 2)
    assert two[ids[2]] == 2 and two[ids[3]] == 2 and two[ids[4]] == 1
    prox = m.proximity_scores([ids[0]], 2)
    assert prox[ids[0]] == 1.0 and prox[ids[1]] == 0.5
    assert prox[ids[2]] == pytest.approx(1 / 3)
    cands = [[ids[0], ids[2], None, "missing-id"],
             [ids[4], ids[1], ids[3], ids[0]]]
    got = m.batch_graph_scores([ids[0]], 2, cands)
    np.testing.assert_allclose(got, [[1.0, 1 / 3, 0, 0], [0, 0.5, 0, 1.0]])
    assert (m.batch_graph_scores([], 2, cands) == 0).all()
    host = cpu_mirror(st)
    per = m.per_anchor_depths([ids[0], ids[5]], 3)
    want = host.per_anchor_depths([ids[0], ids[5]], 3)
    assert set(per) == set(want)
    for k in want:
        assert per[k].tolist() == want[k].tolist()


def test_device_walk_overflow_falls_back_to_relaxation():
    st = MemoryStorage()
    ids = chain(st, 8)
    want = cpu_mirror(st).depths_from([ids[3]], 4)
    m = cpu_mirror(st, HOST_FRONTIER_BUDGET=0, DEVICE_FRONTIER_CAP=1)
    assert m.depths_from([ids[3]], 4) == want
    # more anchors than frontier slots: straight to the relaxation
    two = cpu_mirror(st, HOST_FRONTIER_BUDGET=0, DEVICE_FRONTIER_CAP=1)
    assert two.depths_from([ids[0], ids[7]], 2) == \
        cpu_mirror(st).depths_from([ids[0], ids[7]], 2)


def test_mirror_version_rebuild():
    st = MemoryStorage()
    g = GraphEngine(st)
    ids = chain(st, 2)
    m = DeviceGraphMirror(g.cache, device="cpu")
    assert m.depths_from([ids[0]], 1)[ids[1]] == 1
    c = Node.new("fact", "Added later", "Body added later", Source(agent="t"))
    st.put_node(c)
    st.put_edge(Edge.new(ids[1], c.id, "uses", 0.9,
                         EdgeProvenance.manual("t")))
    g.invalidate()
    assert m.depths_from([ids[0]], 2)[c.id] == 2
    m.HOST_FRONTIER_BUDGET = 0
    assert m.depths_from([ids[0]], 2)[c.id] == 2
    assert m.n == 3 and m.row_of(c.id) is not None


def test_cuda_mirror_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present here: the mirror opens on it")
    from cortex_tpu_torch.errors import DeviceUnavailable
    with pytest.raises(DeviceUnavailable):
        DeviceGraphMirror(AdjacencyCache(MemoryStorage()))


# --------------------------------------------- state carried across


def test_reference_sqlite_file_opens_in_the_port(tmp_path):
    """The carry-over: the reference writes nodes and edges (a deleted
    node, a deleted edge) to SQLite; the port opens the file and its
    mirror builds the reference's neighbor table, row map and packed
    snapshot exactly, and the same depths."""
    path = str(tmp_path / "graph.db")
    ref_st = JaxSqlite(path)
    p = build_pair(seed=8, hub=70, ref_st=ref_st, port_st=MemoryStorage())
    ref_st.delete_edge(p.edges[3])
    ref_mirror = JaxMirror(JaxCache(ref_st))
    ref_mirror.ensure()
    ref_pk = JaxPacked.build(ref_st)
    ref_table = np.asarray(ref_mirror._packed_device_nbrs(ref_pk))
    ref_mirror.HOST_FRONTIER_BUDGET = 0         # the relaxation (G2)
    want_per = ref_mirror.per_anchor([p.ids[0], p.ids[9]], 3)
    ref_st.close()

    port_st = SqliteStorage(path)
    try:
        mirror = DeviceGraphMirror(AdjacencyCache(port_st), device="cpu")
        mirror.ensure()
        np.testing.assert_array_equal(mirror._nbrs.numpy(),
                                      np.asarray(ref_mirror._nbrs))
        assert mirror._row_of == ref_mirror._row_of
        assert mirror._id_of == ref_mirror._id_of
        assert mirror.truncated_nodes == ref_mirror.truncated_nodes == 1
        pk = PackedAdjacency.build(port_st)
        assert pk.ids == ref_pk.ids and pk.row_of == ref_pk.row_of
        assert pk.edge_count == ref_pk.edge_count
        np.testing.assert_array_equal(pk.indptr, ref_pk.indptr)
        np.testing.assert_array_equal(pk.indices, ref_pk.indices)
        np.testing.assert_array_equal(
            mirror._packed_device_nbrs(pk).numpy(), ref_table)
        mirror.HOST_FRONTIER_BUDGET = 0
        assert_per_anchor_equal(want_per,
                                mirror.per_anchor([p.ids[0], p.ids[9]], 3))
    finally:
        port_st.close()
