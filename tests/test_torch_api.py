"""cortex_tpu_torch.Cortex against cortex_tpu.Cortex on the same nodes.

Both run the IVF index (nlist 8, so the default nprobe probes every
cluster), the hash-64 embedder, and the score-decay re-rank with
record_access off. The JAX side runs its Pallas search path (interpret
mode). Criterion, as in __graft_entry__.py:326-342: the same ids,
scores within 1e-4 (decay factors are taken at each call's own clock).
The hash embedder gives exactly tied cosines now and then, and tied
hits come back in candidate order, which follows each layout's slot
order (and the row order, which a rebuild from storage changes). So
ids are held equal rank by rank except among hits whose scores tie
(assert_same).
"""

import copy

import numpy as np
import pytest

from cortex_tpu import Cortex as JaxCortex
from cortex_tpu.config import CortexConfig as JaxConfig
from cortex_tpu.ops import ivf_gather as jax_gather
from cortex_tpu.storage import MemoryStorage
from cortex_tpu.types import Node, Source
from cortex_tpu.vector import VectorFilter as JaxFilter
from cortex_tpu.vector.ivf import (IvfCorpus, _ivf_search_pallas,
                                   _ivf_search_pallas_hostbias)
from cortex_tpu_torch import Cortex
from cortex_tpu_torch.config import CortexConfig
from cortex_tpu_torch.storage import MemoryStorage as TorchMemoryStorage
from cortex_tpu_torch.types import Node as TorchNode
from cortex_tpu_torch.vector import VectorFilter

ATOL = 1e-4
KINDS = ("fact", "event", "decision", "goal", "observation")


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setattr(jax_gather, "INTERPRET", True)
    monkeypatch.setattr(IvfCorpus, "_use_pallas", lambda self, cap: True)
    yield
    jax_gather.probed_scores.clear_cache()
    _ivf_search_pallas.clear_cache()
    _ivf_search_pallas_hostbias.clear_cache()


def configs():
    out = []
    for cfg in (JaxConfig(), CortexConfig()):
        cfg.embedding.index = "ivf"
        cfg.embedding.ivf_graph_degree = 0
        cfg.embedding.model = "hash-64"
        cfg.embedding.ivf_nlist = 8
        out.append(cfg)
    return out


def seeded_nodes(n, seed=0):
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(300)]
    nodes = []
    for i in range(n):
        title = " ".join(rng.choice(vocab, 4)) + f" item{i}"
        body = " ".join(rng.choice(vocab, 10))
        nodes.append(Node.new(KINDS[i % len(KINDS)], title, body,
                              Source(agent=f"agent{i % 3}"),
                              float(rng.uniform(0.2, 0.9))))
    return nodes


def port_nodes(nodes):
    """The port's own Node copies of reference nodes (same fields)."""
    return [TorchNode.from_dict(n.to_dict()) for n in nodes]


class Pair:
    """The same operations on both engines."""

    def __init__(self, kind, tmp_path):
        self.kind = kind
        self.tmp_path = tmp_path
        self.jcfg, self.tcfg = configs()
        self.mem = (MemoryStorage(), TorchMemoryStorage())
        self.open()

    def open(self):
        if self.kind == "memory":
            self.ref = JaxCortex(self.mem[0], self.jcfg)
            self.port = Cortex(self.mem[1], self.tcfg, device="cpu")
        else:
            self.ref = JaxCortex.open(str(self.tmp_path / "jax.db"),
                                      self.jcfg)
            self.port = Cortex.open(str(self.tmp_path / "torch.db"),
                                    self.tcfg, device="cpu")

    def reopen(self):
        """Close (SQLite) and build both engines again from storage."""
        if self.kind == "sqlite":
            self.ref.close()
            self.port.close()
        self.open()

    def close(self):
        if self.kind == "sqlite":
            self.ref.close()
            self.port.close()

    def both(self, fn):
        return fn(self.ref, JaxFilter), fn(self.port, VectorFilter)


@pytest.fixture(params=["memory", "sqlite"])
def pair(request, tmp_path):
    p = Pair(request.param, tmp_path)
    nodes = seeded_nodes(100)
    p.ref.store_batch(copy.deepcopy(nodes))
    p.port.store_batch(port_nodes(nodes))
    for node in seeded_nodes(3, seed=1):
        p.ref.store(copy.deepcopy(node))
        p.port.store(port_nodes([node])[0])
    p.nodes = nodes
    p.deleted = nodes[7].id
    assert p.ref.delete_node(p.deleted) and p.port.delete_node(p.deleted)
    yield p
    p.close()


def queries(nodes):
    return ([f"{n.title} {n.body}" for n in nodes[:12:3]]
            + ["w1 w2 w3 w40", "item9 w100"])


def assert_same(want, got):
    """Same scores rank by rank, the same score for every id both lists
    hold, and a different id at a rank only where scores tie."""
    ws, gs = [s for s, _ in want], [s for s, _ in got]
    np.testing.assert_allclose(gs, ws, atol=ATOL)
    w = {n.id: s for s, n in want}
    g = {n.id: s for s, n in got}
    for nid in w.keys() & g.keys():
        assert abs(w[nid] - g[nid]) <= ATOL
    for (sw, nw), (_, ng) in zip(want, got):
        if nw.id != ng.id:                    # a tie: both score alike
            assert abs(g.get(nw.id, sw) - sw) <= ATOL
            assert abs(w.get(ng.id, sw) - sw) <= ATOL
    for nid in w.keys() ^ g.keys():           # only a tie at the cut-off
        assert abs(w.get(nid, g.get(nid)) - ws[-1]) <= ATOL


SEARCHES = {
    "plain": lambda cx, F, q: cx.search(q, 10, record_access=False),
    "no_decay": lambda cx, F, q: cx.search(q, 10, decay=False,
                                           record_access=False),
    "kinds": lambda cx, F, q: cx.search(
        q, 8, flt=F(kinds=["fact", "goal"]), record_access=False),
    "agent": lambda cx, F, q: cx.search(
        q, 8, flt=F(source_agent="agent1"), record_access=False),
}


@pytest.mark.parametrize("how", list(SEARCHES))
def test_search_parity(pair, how):
    for q in queries(pair.nodes):
        want, got = pair.both(lambda cx, F: SEARCHES[how](cx, F, q))
        assert got
        assert_same(want, got)
        assert pair.deleted not in {n.id for _, n in got}


def test_many_exclusions_take_the_host_bias_route(pair):
    excl = [n.id for n in pair.nodes[20:90]]             # > 64 ids
    q = queries(pair.nodes)[0]
    want, got = pair.both(lambda cx, F: cx.search(
        q, 10, flt=F(exclude_ids=excl), record_access=False))
    assert_same(want, got)
    assert not {n.id for _, n in got} & set(excl)


def test_update_node_parity(pair):
    for cx in (pair.ref, pair.port):
        node = cx.get_node(pair.nodes[11].id)
        node.title = "rewritten title about w5 w6"
        cx.update_node(node)
    q = "rewritten title about w5 w6"
    want, got = pair.both(lambda cx, F: cx.search(q, 5,
                                                  record_access=False))
    assert_same(want, got)
    assert got[0][1].id == pair.nodes[11].id


def test_rebuild_from_storage_parity(pair):
    before = [pair.port.search(q, 10, record_access=False)
              for q in queries(pair.nodes)]
    pair.reopen()
    assert len(pair.port.index) == len(pair.ref.index) == 102
    for q, old in zip(queries(pair.nodes), before):
        want, got = pair.both(lambda cx, F: cx.search(
            q, 10, record_access=False))
        assert_same(want, got)
        assert_same(old, got)


def test_record_access_bumps_counts(pair):
    q = queries(pair.nodes)[1]
    hits = pair.port.search(q, 3)
    stored = pair.port.get_node(hits[0][1].id)
    assert stored.access_count >= 1
    assert len(pair.port.list_nodes()) == 102
