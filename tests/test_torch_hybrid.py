"""cortex_tpu_torch.Cortex.search_hybrid against cortex_tpu.Cortex's, on
the same seeded nodes and edges (the same ids in both packages).

Both engines run the hash-64 embedder over the flat index (the default)
or the IVF index (nlist 8, every list probed; the reference's Pallas
search in interpret mode). Cases: no anchors, anchors, an edge-less
anchor, a kind filter, a deleted node, create_edge / delete_edge
invalidation, and the device tiers of the proximity leg (the mirror's
relaxation and the packed device walk, reached with the instance
overrides the reference's tests use) besides the host tier.

Criterion: graph scores and nearest anchors exactly equal for every id
both lists hold; vector and combined scores within 1e-4 (the `Cortex`
tolerance of the earlier slices); ids equal rank by rank except among
results whose combined scores tie (the hash embedder gives exact ties,
which come back in each layout's candidate order). The vector leg
over-fetches 3 x limit hits, and the fusion can lift any of them to the
top, so a tie AT that cut-off (the hash embedder scores many unrelated
nodes 0, the reference's exact product about 1e-9) would let the two
engines fuse different hit sets: the queries are those whose over-fetch
cut-off is clear of ties in the reference (`clear_cut`).
"""

import copy

import numpy as np
import pytest

from cortex_tpu import Cortex as JaxCortex
from cortex_tpu.config import CortexConfig as JaxConfig
from cortex_tpu.ops import ivf_gather as jax_gather
from cortex_tpu.storage import MemoryStorage
from cortex_tpu.types import Edge as JaxEdge
from cortex_tpu.types import EdgeProvenance as JaxProv
from cortex_tpu.vector.ivf import (IvfCorpus, _ivf_search_pallas,
                                   _ivf_search_pallas_hostbias)
from cortex_tpu_torch import Cortex
from cortex_tpu_torch.config import CortexConfig
from cortex_tpu_torch.graph import PathRequest, TraversalRequest
from cortex_tpu_torch.storage import MemoryStorage as TorchMemoryStorage
from cortex_tpu_torch.types import Edge
from test_torch_api import port_nodes, seeded_nodes

ATOL = 1e-4
TIERS = {"host": {}, "object_relax": {"HOST_FRONTIER_BUDGET": 0},
         "packed_walk": {"PACKED_EDGE_THRESHOLD": 0,
                         "HOST_FRONTIER_BUDGET": 0}}


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setattr(jax_gather, "INTERPRET", True)
    monkeypatch.setattr(IvfCorpus, "_use_pallas", lambda self, cap: True)
    yield
    jax_gather.probed_scores.clear_cache()
    _ivf_search_pallas.clear_cache()
    _ivf_search_pallas_hostbias.clear_cache()


def configs(index):
    out = []
    for cfg in (JaxConfig(), CortexConfig()):
        cfg.embedding.model = "hash-64"
        if index == "ivf":
            cfg.embedding.index = "ivf"
            cfg.embedding.ivf_nlist = 8
        out.append(cfg)
    return out


class Engines:
    """The reference's and the port's Cortex over the same 80 nodes, ~160
    seeded edges among the first 60, and one soft-deleted node."""

    def __init__(self, index, tmp_path=None):
        jcfg, tcfg = configs(index)
        if tmp_path is None:
            self.ref = JaxCortex(MemoryStorage(), jcfg)
            self.port = Cortex(TorchMemoryStorage(), tcfg, device="cpu")
        else:
            self.ref = JaxCortex.open(str(tmp_path / "jax.db"), jcfg)
            self.port = Cortex.open(str(tmp_path / "torch.db"), tcfg,
                                    device="cpu")
        self.nodes = seeded_nodes(80, seed=5)
        self.ref.store_batch(copy.deepcopy(self.nodes))
        self.port.store_batch(port_nodes(self.nodes))
        self.ids = [n.id for n in self.nodes]
        rng = np.random.default_rng(5)
        self.edges = []
        made = set()
        for _ in range(200):
            a, b = (int(x) for x in rng.integers(0, 60, 2))
            if a == b or (a, b) in made:
                continue
            made.add((a, b))
            self.edges.append(self.link(self.ids[a], self.ids[b]))
        self.deleted = self.ids[12]
        assert self.ref.delete_node(self.deleted)
        assert self.port.delete_node(self.deleted)

    def link(self, a, b, weight=0.6):
        e = JaxEdge.new(a, b, "related_to", weight, JaxProv.manual("t"))
        assert self.ref.create_edge(copy.deepcopy(e)) == \
            self.port.create_edge(Edge.from_dict(e.to_dict()))
        return e.id

    def tier(self, name):
        for m in (self.ref.mirror, self.port.mirror):
            for k, v in TIERS[name].items():
                setattr(m, k, v)

    def close(self):
        for cx in (self.ref, self.port):
            cx.close()


@pytest.fixture(params=["flat", "ivf"])
def engines(request):
    e = Engines(request.param)
    yield e
    e.close()


def assert_same(want, got):
    assert len(got) == len(want)
    wc = [r.combined_score for r in want]
    np.testing.assert_allclose([r.combined_score for r in got], wc,
                               atol=ATOL)
    w = {r.node.id: r for r in want}
    g = {r.node.id: r for r in got}
    for nid in w.keys() & g.keys():
        assert g[nid].graph_score == w[nid].graph_score
        assert g[nid].nearest_anchor == w[nid].nearest_anchor
        assert abs(g[nid].vector_score - w[nid].vector_score) <= ATOL
        assert abs(g[nid].combined_score - w[nid].combined_score) <= ATOL
    for rw, rg in zip(want, got):
        if rw.node.id != rg.node.id:            # a tie: both score alike
            assert abs(rw.combined_score - rg.combined_score) <= ATOL
    for nid in w.keys() ^ g.keys():             # only a tie at the cut-off
        r = w.get(nid) or g.get(nid)
        assert abs(r.combined_score - wc[-1]) <= ATOL


def queries(e):
    return [f"{n.title} {n.body}" for n in e.nodes[:40:8]] + \
        ["w1 w2 w3 w40", "item9 w100"]


def clear_cut(e, q, limit=10, kind_filter=None, **_):
    """The reference's vector over-fetch (3 x limit) holds every match,
    or its last hit scores clearly above the next."""
    import cortex_tpu.vector as jv
    k = limit * 3
    flt = jv.VectorFilter(kinds=kind_filter) if kind_filter else None
    hits = e.ref.index.search(e.ref.embedder.embed(q), k + 1, flt)
    return len(hits) <= k or hits[k - 1][1] - hits[k][1] > 1e-3


CASES = {
    "no_anchors": lambda e: dict(anchors=()),
    "anchors": lambda e: dict(anchors=(e.ids[0], e.ids[17], e.ids[33])),
    "edgeless_anchor": lambda e: dict(anchors=(e.ids[70], e.ids[3])),
    "kind_filter": lambda e: dict(anchors=(e.ids[2],),
                                  kind_filter=["fact", "goal"]),
    "deep_weighted": lambda e: dict(anchors=(e.ids[5], e.ids[8]),
                                    vector_weight=0.3, max_anchor_depth=5,
                                    limit=12),
}


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("case", list(CASES))
def test_search_hybrid_matches_reference(engines, case, tier):
    engines.tier(tier)
    kw = CASES[case](engines)
    qs = [q for q in queries(engines) if clear_cut(engines, q, **kw)]
    assert len(qs) >= 2
    for q in qs:
        want = engines.ref.search_hybrid(q, **kw)
        got = engines.port.search_hybrid(q, **kw)
        assert got
        assert_same(want, got)
        assert engines.deleted not in {r.node.id for r in got}
        if kw.get("kind_filter"):
            assert {r.node.kind for r in got} <= set(kw["kind_filter"])
        for anchor in kw.get("anchors", ()):
            for r in got:
                if r.node.id == anchor:
                    assert r.graph_score == 1.0
                    assert r.nearest_anchor == (anchor, 0)


def test_edges_invalidate_the_proximity_leg(engines):
    """create_edge and delete_edge reach the next search in both
    packages alike: a new edge from the anchor gives its target depth 1
    (graph score 0.5), deleting it takes that away again."""
    anchor, far = engines.ids[75], engines.ids[40]
    q = f"{engines.nodes[40].title} {engines.nodes[40].body}"

    def score():
        want = engines.ref.search_hybrid(q, (anchor,), limit=5)
        got = engines.port.search_hybrid(q, (anchor,), limit=5)
        assert_same(want, got)
        return {r.node.id: r.graph_score for r in got}.get(far)

    assert score() == 0.0
    eid = engines.link(anchor, far)
    assert score() == 0.5
    assert engines.ref.delete_edge(eid) and engines.port.delete_edge(eid)
    assert score() == 0.0


def test_graph_queries_match_reference(engines):
    import cortex_tpu.graph as jg
    for nid in engines.ids[:6]:
        want = engines.ref.neighborhood(nid, 2)
        got = engines.port.neighborhood(nid, 2)
        assert got.depths == want.depths
        assert [e.id for e in got.edges] == [e.id for e in want.edges]
        t_want = engines.ref.traverse(jg.TraversalRequest(
            start=[nid], max_depth=3, direction=jg.BOTH))
        t_got = engines.port.traverse(TraversalRequest(
            start=[nid], max_depth=3, direction="both"))
        assert list(t_got.nodes) == list(t_want.nodes)
        p_want = engines.ref.find_paths(jg.PathRequest(
            from_id=nid, to_id=engines.ids[30], max_paths=2))
        p_got = engines.port.find_paths(PathRequest(
            from_id=nid, to_id=engines.ids[30], max_paths=2))
        # Yen's candidates tie-break on id(nodes), a memory address
        # (graph/paths.py:187, both packages), so among equally long and
        # heavy paths the order after the first is not fixed
        assert [(p.nodes, p.edges) for p in p_got.paths[:1]] == \
            [(p.nodes, p.edges) for p in p_want.paths[:1]]
        assert sorted((len(p.edges), p.total_weight)
                      for p in p_got.paths) == \
            sorted((len(p.edges), p.total_weight) for p in p_want.paths)


def test_hooks_see_edge_mutations(engines):
    seen = []
    engines.port.hooks.add_fn(on_edge=lambda action, e: seen.append(
        (action, e.id)))
    eid = engines.link(engines.ids[61], engines.ids[62])
    assert engines.port.delete_edge(eid)
    assert not engines.port.delete_edge(eid)
    assert seen == [("created", eid), ("deleted", eid)]


@pytest.mark.parametrize("index", ["flat", "ivf"])
def test_reopen_keeps_hybrid_results(index, tmp_path):
    e = Engines(index, tmp_path)
    kw = CASES["anchors"](e)
    qs = [q for q in queries(e) if clear_cut(e, q, **kw)]
    before = [e.port.search_hybrid(q, **kw) for q in qs]
    e.close()
    jcfg, tcfg = configs(index)
    e.ref = JaxCortex.open(str(tmp_path / "jax.db"), jcfg)
    e.port = Cortex.open(str(tmp_path / "torch.db"), tcfg, device="cpu")
    try:
        for q, old in zip(qs, before):
            got = e.port.search_hybrid(q, **kw)
            assert_same(e.ref.search_hybrid(q, **kw), got)
            assert_same(old, got)
    finally:
        e.close()
