"""The port's host services held against cortex_tpu on the same inputs:
the write gate, briefings, retention (and its kernel R1), the prompt
subsystem, the query DSL, stats and reindex, through both packages'
Cortex.

  * the copies: every module the port keeps as the reference's (gate,
    query, policies, briefing, prompt, kinds, relations) agrees with it
    line for line but for imports, as does apply_score_decay;
  * R1's function: the port's retention_eligibility (its plain version
    on the CPU) against the reference's jitted one (on JAX's CPU
    backend), bit for bit, over 100,003 seeded nodes with rows exactly
    on each boundary, the min_score < 0 sentinel, ttl_days == 0,
    protection on and off, and every parameter broadcast or one a node;
    the reciprocal multiply is what makes it so (the true quotient
    differs on some rows); its ValueError limits;
  * the slice through Cortex, memory and SQLite, flat and IVF index
    (nlist 8: every list probed; the reference's Pallas scan in
    interpret mode), hash-64 embedder: gated stores (accepted, and
    rejected by each check, with the GateRejection's fields), the
    classifier hooks in store and store_batch, briefings (sections, both
    renderings, the cache across a write), run_retention (counts and the
    swept and purged ids), query, stats, reindex (and the old index
    released) and the typed constructors: all equal;
  * the configuration: a TOML with every section parses into the same
    dataclasses, field by field; invalid values raise the same
    ConfigErrors;
  * state carried across: a SQLite file the reference wrote (prompts
    with versions and a rollback, audit rows, aged nodes and edges)
    opens in the port, whose briefing, query, prompt resolution, audit
    log and run_retention give the reference's results.

Tolerances: scores 1e-5 (both packages search with the exact fp32
product on the CPU); everything else exact. Times: each Cortex call
takes its own clock, so every aged node lies days from any boundary.
"""

import copy
import dataclasses
import re
import shutil
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cortex_tpu.vector.scoring as jax_scoring
from cortex_tpu import Cortex as JaxCortex
from cortex_tpu.config import CortexConfig as JaxConfig
from cortex_tpu.errors import ConfigError as JaxConfigError
from cortex_tpu.errors import GateRejection as JaxRejection
from cortex_tpu.gate.schema import KindSchema as JaxKindSchema
from cortex_tpu.ops import decay as jax_decay
from cortex_tpu.ops import ivf_gather as jax_gather
from cortex_tpu.policies import KindRetention as JaxKindRetention
from cortex_tpu.policies import RetentionConfig as JaxRetentionConfig
from cortex_tpu.prompt import PromptContent as JaxPromptContent
from cortex_tpu.types import Edge as JaxEdge
from cortex_tpu.types import EdgeProvenance as JaxProv
from cortex_tpu.types import Node as JaxNode
from cortex_tpu.types import Source as JaxSource
from cortex_tpu.vector.ivf import (IvfCorpus, _ivf_search_pallas,
                                   _ivf_search_pallas_hostbias)
import cortex_tpu_torch.vector.scoring as port_scoring
from cortex_tpu_torch import Cortex
from cortex_tpu_torch.config import CortexConfig
from cortex_tpu_torch.errors import ConfigError, GateRejection
from cortex_tpu_torch.errors import IndexError_
from cortex_tpu_torch.gate.schema import KindSchema
from cortex_tpu_torch.ops import decay as port_decay
from cortex_tpu_torch.policies import KindRetention, RetentionConfig
from cortex_tpu_torch.prompt import PromptContent
from cortex_tpu_torch.types import Edge, Node

REPO = Path(__file__).resolve().parent.parent
COPIES = ("kinds.py", "relations.py", "query/__init__.py", "query/dsl.py",
          "gate/__init__.py", "gate/schema.py", "policies/__init__.py",
          "policies/audit.py", "policies/retention.py",
          "briefing/__init__.py", "briefing/cache.py",
          "briefing/renderer.py", "briefing/engine.py",
          "briefing/precompute.py", "prompt/__init__.py", "prompt/model.py",
          "prompt/resolver.py", "prompt/selection.py",
          "prompt/rollback.py")
SCORE_ATOL = 1e-5
DAY = 86400.0
KINDS = ("fact", "event", "observation", "goal", "decision")
WORDS = [f"{a}{b}" for a in ("kor", "val", "mip", "tes", "dor", "ral",
                             "sim", "pan", "lud", "fer")
         for b in ("ax", "ed", "io", "un", "ar", "os", "ik", "um")]


def _without_imports(text):
    return [line for line in text.splitlines()
            if not re.match(r"\s*(from|import)\s", line)]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_matches_reference(rel):
    ref = (REPO / "cortex_tpu" / rel).read_text()
    port = (REPO / "cortex_tpu_torch" / rel).read_text()
    assert _without_imports(port) == _without_imports(ref)


def test_apply_score_decay_matches_reference():
    import inspect
    assert inspect.getsource(port_scoring.apply_score_decay) == \
        inspect.getsource(jax_scoring.apply_score_decay)


# ---------------------------------------------------------------- R1

NOW = np.float32(1.76e9)


def retention_inputs(n, seed):
    """Node arrays with rows on every boundary: age exactly ttl days
    (in float32 seconds), idle exactly grace days, score exactly
    min_score; and the parameters, each as one value and as one a node
    (ttl 0 and min_score < 0 on some rows)."""
    rng = np.random.default_rng(seed)
    ttl, grace, min_score = 30.0, 10.0, 0.4
    age = rng.uniform(0.0, 80.0, n) * DAY
    idle = rng.uniform(0.0, 40.0, n) * DAY
    created = (NOW - age).astype(np.float32)
    last = (NOW - idle).astype(np.float32)
    score = rng.uniform(0.0, 1.0, n).astype(np.float32)
    inbound = rng.random(n) < 0.3
    created[::97] = NOW - np.float32(ttl * DAY)
    last[::89] = NOW - np.float32(grace * DAY)
    score[::83] = np.float32(min_score)
    created[1::211] = NOW                      # age 0
    last[2::223] = created[2::223]             # never accessed since
    per_node = dict(
        now=np.full(n, NOW, np.float32) + rng.integers(
            -2, 3, n).astype(np.float32) * 128,
        ttl_days=rng.choice(np.array([0.0, 20.0, 30.0, 60.0], np.float32),
                            n),
        grace_days=rng.choice(np.array([0.0, 10.0, 30.0], np.float32), n),
        min_score=rng.choice(np.array([-1.0, 0.2, 0.4, 0.7], np.float32),
                             n),
        protect_inbound=rng.random(n) < 0.5)
    scalar = dict(now=NOW, ttl_days=np.float32(ttl),
                  grace_days=np.float32(grace),
                  min_score=np.float32(min_score),
                  protect_inbound=np.bool_(True))
    return (created, last, score, inbound), scalar, per_node


def reference_mask(nodes, params):
    return np.asarray(jax_decay.retention_eligibility(
        *(jnp.asarray(a) for a in nodes),
        *(jnp.asarray(params[k]) for k in (
            "now", "ttl_days", "grace_days", "min_score",
            "protect_inbound"))))


def port_mask(nodes, params):
    return port_decay.retention_eligibility(
        *(torch.from_numpy(np.asarray(a)) for a in nodes),
        *(torch.as_tensor(params[k]) for k in (
            "now", "ttl_days", "grace_days", "min_score",
            "protect_inbound"))).numpy()


@pytest.mark.parametrize("case", [
    "broadcast", "no_protection", "no_score_floor", "ttl_zero",
    "per_node", "per_node_ttl_only"])
def test_retention_eligibility_matches_reference(case):
    nodes, scalar, per_node = retention_inputs(100_003, seed=7)
    params = dict(scalar)
    if case == "no_protection":
        params["protect_inbound"] = np.bool_(False)
    elif case == "no_score_floor":
        params["min_score"] = np.float32(-1.0)
    elif case == "ttl_zero":
        params["ttl_days"] = np.float32(0.0)
    elif case == "per_node":
        params = per_node
    elif case == "per_node_ttl_only":
        params["ttl_days"] = per_node["ttl_days"]
    want = reference_mask(nodes, params)
    got = port_mask(nodes, params)
    assert got.dtype == np.bool_ and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if case == "ttl_zero":
        assert not want.any()
    else:
        assert 0 < want.sum() < len(want)


def test_retention_boundary_rows_decide_as_reference():
    """Rows exactly on each boundary are not expired / idle / unimportant
    (strict comparisons), in both packages."""
    nodes, scalar, _ = retention_inputs(100_003, seed=7)
    created, last, score, inbound = nodes
    on_ttl = created == NOW - np.float32(30.0 * DAY)
    got = port_mask(nodes, scalar)
    assert on_ttl.sum() > 1000
    assert not got[on_ttl].any()
    np.testing.assert_array_equal(got, reference_mask(nodes, scalar))


def test_retention_reciprocal_multiply_matters():
    """XLA multiplies by float32(1 / 86400): the true float32 quotient
    differs from it on some rows, and the port's plain version spells
    the multiply."""
    rng = np.random.default_rng(3)
    t = (NOW - rng.uniform(0.0, 400.0, 200_000) * DAY).astype(np.float32)
    now = torch.tensor(NOW)
    quotient = ((now - torch.from_numpy(t)) / 86400.0).numpy()
    product = ((now - torch.from_numpy(t))
               * torch.tensor(port_decay._INV_DAY)).numpy()
    assert (quotient != product).sum() > 100
    # the reference's jitted age, as XLA compiles it, is the product
    import jax
    xla = np.asarray(jax.jit(lambda a, b: (a - b) / 86400.0)(
        jnp.float32(NOW), jnp.asarray(t)))
    np.testing.assert_array_equal(xla, product)


def test_retention_eligibility_limits():
    n = 5
    f = torch.zeros(n)
    b = torch.zeros(n, dtype=torch.bool)
    ok = port_decay.retention_eligibility(f, f, f, b, 1e9, 1.0, 1.0, -1.0,
                                          True)
    assert ok.dtype == torch.bool and ok.shape == (n,)
    assert port_decay.retention_eligibility(
        torch.zeros(0), torch.zeros(0), torch.zeros(0),
        torch.zeros(0, dtype=torch.bool), 1e9, 1.0, 1.0, -1.0,
        True).shape == (0,)
    # float64 and int inputs are converted, as JAX converts them
    got = port_decay.retention_eligibility(
        f.double(), f.double(), f.double(), b.int(), np.float64(1e9),
        np.int64(1), 1.0, -1.0, 1)
    assert torch.equal(got, ok)
    for bad in (
            (f[None], f, f, b, 1e9, 1.0, 1.0, 0.5, True),    # 2-d nodes
            (f, f[:4], f, b, 1e9, 1.0, 1.0, 0.5, True),      # wrong N
            (f, f, f, b[:4], 1e9, 1.0, 1.0, 0.5, True),
            (f, f, f, b, torch.zeros(4), 1.0, 1.0, 0.5, True),
            (f, f, f, b, 1e9, torch.zeros(1), 1.0, 0.5, True),
            (f, f, f, b, 1e9, 1.0, torch.zeros(n, 1), 0.5, True),
            (f, f, f, b, 1e9, 1.0, 1.0, 0.5, torch.ones(2, 2)),
            (f, 1.0, f, b, 1e9, 1.0, 1.0, 0.5, True),        # 0-d node array
            (f.numpy(), f, f, b, 1e9, 1.0, 1.0, 0.5, True)):
        with pytest.raises(ValueError):
            port_decay.retention_eligibility(*bad)


# ------------------------------------------------- the slice through Cortex


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setattr(jax_gather, "INTERPRET", True)
    monkeypatch.setattr(IvfCorpus, "_use_pallas", lambda self, cap: True)
    yield
    jax_gather.probed_scores.clear_cache()
    _ivf_search_pallas.clear_cache()
    _ivf_search_pallas_hostbias.clear_cache()


def configs(index, *, retention=False, schemas=False):
    out = []
    for cfg, kr, rc, ks in ((JaxConfig(), JaxKindRetention,
                             JaxRetentionConfig, JaxKindSchema),
                            (CortexConfig(), KindRetention, RetentionConfig,
                             KindSchema)):
        cfg.embedding.model = "hash-64"
        cfg.embedding.dimension = 64
        cfg.embedding.index = index
        cfg.embedding.ivf_nlist = 8
        if retention:
            cfg.retention = rc(
                default_ttl_days=60.0, grace_days=10.0,
                by_kind={"observation": kr(ttl_days=30.0),
                         "event": kr(ttl_days=20.0, min_score=0.5),
                         "goal": kr(ttl_days=0.0)})
        if schemas:
            cfg.schemas = {"goal": ks.from_dict(
                {"required_fields": ["owner"]})}
        out.append(cfg)
    return out


def sentence(rng, n):
    return " ".join(rng.choice(WORDS, n))


def topic_node(i, rng, *, kind=None, agent=None):
    kind = kind or KINDS[i % len(KINDS)]
    body = f"The {sentence(rng, 12)} service record {i}"
    if kind == "decision":
        body = f"We decided to use {sentence(rng, 10)} for record {i}"
    n = JaxNode.new(kind, f"Record {i} {sentence(rng, 3)}", body,
                    JaxSource(agent=agent or f"agent{i % 4}"),
                    float(rng.uniform(0.3, 0.65)))
    if kind == "goal":
        n.metadata = {"owner": f"agent{i % 4}"}
    return n


def port_node(node):
    return Node.from_dict(node.to_dict())


def port_edge(edge):
    return Edge.from_dict(edge.to_dict())


class Pair:
    """The same operations on the reference's Cortex and the port's."""

    def __init__(self, kind, index, tmp_path, **cfg):
        self.kind = kind
        jcfg, tcfg = configs(index, **cfg)
        if kind == "memory":
            self.ref = JaxCortex.in_memory(jcfg)
            self.port = Cortex.in_memory(tcfg, device="cpu")
        else:
            self.ref = JaxCortex.open(str(tmp_path / "jax.db"), jcfg)
            self.port = Cortex.open(str(tmp_path / "torch.db"), tcfg,
                                    device="cpu")

    def store_batch(self, nodes):
        self.ref.store_batch(copy.deepcopy(nodes))
        self.port.store_batch([port_node(n) for n in nodes])

    def edge(self, a, b, relation, weight=0.9):
        e = JaxEdge.new(a.id, b.id, relation, weight, JaxProv.manual("t"))
        self.ref.create_edge(copy.deepcopy(e))
        self.port.create_edge(port_edge(e))

    def close(self):
        if self.kind == "sqlite":
            self.ref.close()
            self.port.close()


PAIRS = [(k, i) for k in ("memory", "sqlite") for i in ("flat", "ivf")]


def outcome(cx, node, **kw):
    try:
        return ("stored", cx.store(node, gate=True, **kw))
    except (JaxRejection, GateRejection) as e:
        return ("rejected", e.check, e.reason, e.suggestion,
                e.existing_node, e.existing_title)


def gate_candidates(stored, rng):
    """Fresh nodes, exact re-submissions under new ids (other agent:
    duplicates), near copies with one or two body words changed (same
    kind, same or other agent: duplicates and contradictions), and
    nodes that fail substance, specificity or the schema."""
    out = []
    for j in range(12):
        out.append(topic_node(1000 + j, rng))
    for j, base in enumerate(stored[:24]):
        if j % 3 == 0:
            n = JaxNode.new(base.kind, base.title, base.body,
                            JaxSource(agent="resubmitter"), base.importance)
        else:
            words = base.body.split()
            words[3] = "zzq"
            if j % 2:
                words[5] = "qqz"
            agent = base.source.agent if j % 3 == 1 else "other-agent"
            n = JaxNode.new(base.kind, base.title, " ".join(words),
                            JaxSource(agent=agent), base.importance)
        n.metadata = dict(base.metadata)
        out.append(n)
    out.append(JaxNode.new("fact", "Short", "A body long enough to pass",
                           JaxSource(agent="a"), 0.5))
    out.append(JaxNode.new("fact", "A fine title here", "tiny body",
                           JaxSource(agent="a"), 0.5))
    out.append(JaxNode.new("fact", "What happened yesterday in standup",
                           "The standup covered the deploy pipeline.",
                           JaxSource(agent="a"), 0.5))
    out.append(JaxNode.new("goal", "Ship the release train",
                           "The release train ships every second week.",
                           JaxSource(agent="a"), 0.5))     # no owner
    return out


@pytest.mark.parametrize("kind,index", PAIRS)
def test_gated_store_decisions_match_reference(kind, index, tmp_path):
    p = Pair(kind, index, tmp_path, schemas=True)
    rng = np.random.default_rng(11)
    stored = [topic_node(i, rng) for i in range(120)]
    p.store_batch(stored)
    seen = set()
    for node in gate_candidates(stored, rng):
        want = outcome(p.ref, copy.deepcopy(node))
        got = outcome(p.port, port_node(node))
        assert got == want, node.title
        seen.add(want[1] if want[0] == "rejected" else "stored")
        if want[0] == "rejected" and want[1] == "conflict":
            seen.add(want[2].split(" (")[0])
    assert seen >= {"stored", "substance", "specificity", "conflict",
                    "schema", "Near-duplicate found",
                    "Potential contradiction with existing node"}
    # skip_quality: only the schema check runs
    lax = JaxNode.new("fact", "Short", "tiny", JaxSource(agent="a"), 0.5)
    assert outcome(p.port, port_node(lax), skip_quality=True) == \
        outcome(p.ref, copy.deepcopy(lax), skip_quality=True) == \
        ("stored", lax.id)
    assert len(p.port.index) == len(p.ref.index)
    p.close()


@pytest.mark.parametrize("kind,index", PAIRS)
def test_classifiers_match_reference(kind, index, tmp_path):
    p = Pair(kind, index, tmp_path)

    def label(node):
        return "odd" if len(node.body) % 2 else None

    def broken(node):
        raise RuntimeError("a classifier fault never blocks a write")

    for cx in (p.ref, p.port):
        cx.classifiers.extend([broken, label])
    rng = np.random.default_rng(5)
    nodes = [topic_node(i, rng) for i in range(30)]
    p.store_batch(nodes[:20])
    for n in nodes[20:]:
        p.ref.store(copy.deepcopy(n))
        p.port.store(port_node(n))
    labels = [(n.id, n.metadata.get("classification"))
              for n in p.port.list_nodes()]
    assert sorted(labels) == sorted(
        (n.id, n.metadata.get("classification"))
        for n in p.ref.list_nodes())
    assert {v for _, v in labels} == {"odd", None}
    p.close()


def briefing_world(p, rng):
    """Agents with and without an agent node: preferences and patterns
    that apply to them, goals they depend on, a contradiction, recent
    events and a novel kind."""
    agents = ["kai", "ana", "zoe"]
    nodes = []
    for a in agents[:2]:
        nodes.append(JaxNode.new("agent", f"{a.title()} the assistant",
                                 f"Agent {a} handles {sentence(rng, 6)}",
                                 JaxSource(agent=a), 0.8))
    for i in range(60):
        kind = ("preference", "pattern", "goal", "event", "fact",
                "decision", "runbook")[i % 7]
        n = topic_node(i, rng, kind=kind if kind != "decision" else None,
                       agent=agents[i % 3])
        if kind == "pattern":
            n.body = f"The deploy always {sentence(rng, 8)} record {i}"
        nodes.append(n)
    p.store_batch(nodes)
    by_agent = {a: [n for n in nodes if n.source.agent == a]
                for a in agents}
    for a in agents[:2]:
        me = by_agent[a][0]
        for n in by_agent[a][1:]:
            if n.kind in ("preference", "pattern", "fact"):
                p.edge(n, me, "applies_to")
            elif n.kind == "goal":
                p.edge(me, n, "depends_on")
    facts = [n for n in nodes if n.kind == "fact"]
    p.edge(facts[0], facts[1], "contradicts")
    p.edge(by_agent["kai"][0], facts[0], "related_to")
    return agents


def briefing_key(b):
    return (b.agent_id, b.nodes_consulted, b.cached,
            [(s.title, [n.id for n in s.nodes]) for s in b.sections])


def without_clock(text):
    return "\n".join(line for line in text.splitlines()
                     if "Generated" not in line)


@pytest.mark.parametrize("kind,index", PAIRS)
def test_briefings_match_reference(kind, index, tmp_path):
    p = Pair(kind, index, tmp_path)
    agents = briefing_world(p, np.random.default_rng(13))
    for a in agents:
        want, got = p.ref.briefing_full(a), p.port.briefing_full(a)
        assert briefing_key(got) == briefing_key(want)
        assert len(want.sections) >= 3
        # the second call hits the cache in both
        assert p.ref.briefing_full(a).cached
        assert p.port.briefing_full(a).cached
        for compact in (False, True):
            assert without_clock(p.port.briefing(a, compact=compact)) == \
                without_clock(p.ref.briefing(a, compact=compact))
    # a write bumps the graph version: the next briefing is generated anew
    extra = topic_node(500, np.random.default_rng(1), kind="event",
                       agent="kai")
    p.ref.store(copy.deepcopy(extra))
    p.port.store(port_node(extra))
    want, got = p.ref.briefing_full("kai"), p.port.briefing_full("kai")
    assert not got.cached and not want.cached
    assert briefing_key(got) == briefing_key(want)
    assert extra.id in {n.id for s in got.sections for n in s.nodes}
    assert p.port.graph_version.get() == p.ref.graph_version.get()
    p.close()


def aged(node, age_days, idle_days, now):
    node.created_at = now - age_days * DAY
    node.last_accessed_at = now - idle_days * DAY
    node.updated_at = node.created_at
    return node


def retention_world(p, rng):
    """Nodes well past and well inside each TTL and the grace window,
    inbound edges from live nodes into some expired ones, hot nodes
    that the event kind's min_score keeps, and backdated tombstones."""
    now = time.time()
    nodes = []
    for i in range(80):
        kind = ("observation", "event", "goal", "fact")[i % 4]
        n = topic_node(i, rng, kind=kind)
        age = (5.0, 45.0, 100.0, 200.0)[(i // 4) % 4]
        idle = (2.0, 15.0, 50.0)[(i // 16) % 3]
        aged(n, age, idle, now)
        if i % 5 == 0:
            n.access_count = 200            # echo keeps the score high
        nodes.append(n)
    p.store_batch(nodes)
    fresh = [n for n in nodes if n.created_at > now - 6 * DAY]
    old = [n for n in nodes[::7] if n.created_at < now - 6 * DAY]
    for j, n in enumerate(old):
        p.edge(fresh[j % len(fresh)], n, "informed_by")
    stones = [aged(topic_node(900 + i, rng), 300.0, 300.0, now)
              for i in range(4)]
    p.store_batch(stones)
    for cx, conv in ((p.ref, copy.deepcopy), (p.port, port_node)):
        for i, s in enumerate(stones):
            cx.delete_node(s.id)
            got = cx.storage.get_node(s.id)
            got.updated_at = now - (40.0 if i % 2 else 5.0) * DAY
            cx.storage.put_node(got)
    return nodes, stones


def live_ids(cx):
    return sorted(n.id for n in cx.list_nodes())


@pytest.mark.parametrize("kind,index", PAIRS)
def test_run_retention_matches_reference(kind, index, tmp_path):
    p = Pair(kind, index, tmp_path, retention=True)
    nodes, stones = retention_world(p, np.random.default_rng(17))
    before = set(live_ids(p.port))
    want, got = p.ref.run_retention(), p.port.run_retention()
    assert got == want
    assert want[0] > 5 and want[1] == 2
    assert live_ids(p.port) == live_ids(p.ref)
    swept = before - set(live_ids(p.port))
    assert len(swept) == want[0]
    # swept nodes left the live index: the gate no longer sees them
    for nid in swept:
        assert nid not in p.port.index and nid not in p.ref.index
    purged = {s.id for s in stones if p.port.storage.get_node(s.id) is None}
    assert purged == {s.id for s in stones
                      if p.ref.storage.get_node(s.id) is None}
    assert len(purged) == 2
    p.close()


def assert_same_hits(got, want):
    """Scores within SCORE_ATOL rank by rank; ids equal but among hits
    whose scores tie (the hash embedder ties exactly now and then, and
    tied hits come back in each index's row order). The last tie group
    may be cut by the limit, so only its size is held."""
    gs, ws = [s for _, s in got], [s for _, s in want]
    np.testing.assert_allclose(gs, ws, atol=SCORE_ATOL)
    groups = {}
    for (gi, g), (wi, _) in zip(got, want):
        key = round(g / SCORE_ATOL)
        a, b = groups.setdefault(key, (set(), set()))
        a.add(gi)
        b.add(wi)
    last = round(gs[-1] / SCORE_ATOL) if gs else None
    for key, (a, b) in groups.items():
        assert len(a) == len(b)
        if key != last:
            assert a == b


QUERIES = ["kind:fact", "kind:event,goal", "agent:agent1",
           "importance>0.5 AND kind:observation", "NOT deleted:true",
           "kind:fact OR kind:decision", "created_after:30d",
           "tags:none", "importance<=0.4 AND limit:5",
           "(kind:decision OR kind:goal) AND agent:agent2"]


@pytest.mark.parametrize("kind,index", PAIRS)
def test_query_stats_reindex_constructors_match_reference(kind, index,
                                                          tmp_path):
    p = Pair(kind, index, tmp_path)
    rng = np.random.default_rng(19)
    nodes = [topic_node(i, rng) for i in range(90)]
    aged(nodes[0], 40.0, 40.0, time.time())
    p.store_batch(nodes)
    p.edge(nodes[1], nodes[2], "related_to")
    p.ref.delete_node(nodes[3].id)
    p.port.delete_node(nodes[3].id)
    for q in QUERIES:
        assert [n.id for n in p.port.query(q)] == \
            [n.id for n in p.ref.query(q)], q
    want, got = p.ref.stats(), p.port.stats()
    for f in ("node_count", "edge_count", "deleted_node_count",
              "nodes_by_kind", "edges_by_relation"):
        assert getattr(got, f) == getattr(want, f), f

    def hits(cx):
        return [(n.id, s) for s, n in cx.search(
            "service record 7", 10, record_access=False, decay=False)]

    before = hits(p.port)
    old = p.port.index
    assert p.port.reindex() == p.ref.reindex() == 89
    after = hits(p.port)
    assert_same_hits(after, before)
    assert_same_hits(after, hits(p.ref))
    # every holder was re-pointed, and the old index was released
    cx = p.port
    assert cx.index is not old
    assert cx.hybrid.index is cx.briefing_engine.index is \
        cx.linker.index is cx.index
    with pytest.raises(IndexError_):
        old.search(np.ones(64, np.float32), 3)
    for name, args in (("fact", ("A fact title",)),
                       ("decision", ("A decision", "We will use it")),
                       ("event", ("An event", "It happened")),
                       ("goal", ("A goal", "Reach it")),
                       ("observation", ("An observation", "Seen")),
                       ("pattern", ("A pattern", "Always so")),
                       ("preference", ("A preference", "Likes it")),
                       ("agent", ("An agent", "Acts"))):
        a = getattr(JaxCortex, name)(*args).to_dict()
        b = getattr(Cortex, name)(*args).to_dict()
        for d in (a, b):
            for k in ("id", "created_at", "updated_at", "last_accessed_at"):
                d.pop(k)
        assert b == a, name
    p.close()


def test_release_discards_and_joins_the_background_graph_build(
        monkeypatch):
    """Closing an IVF index (reindex closes the one it replaces) while
    its kNN graph builds on the background thread: the build's table
    is discarded, the thread is joined before close returns, and a
    search on the closed index raises."""
    import threading
    import cortex_tpu_torch.vector.ivf as port_ivf
    import cortex_tpu_torch.vector.knn_graph as port_kg
    from cortex_tpu_torch.vector import TorchIvfIndex
    monkeypatch.setattr(port_ivf, "WARM_MIN_SLOTS", 1)
    rng = np.random.default_rng(5)
    vecs = rng.normal(size=(300, 32)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    idx = TorchIvfIndex(32, nlist=6, nprobe=2, graph_degree=8, device="cpu")
    idx.insert_batch([f"n{i}" for i in range(300)], vecs)
    co = idx._corpus
    orig, started, gate = port_kg.build_knn_graph, threading.Event(), \
        threading.Event()

    def held_build(*a, **k):
        started.set()
        gate.wait(10)
        return orig(*a, **k)

    monkeypatch.setattr(port_kg, "build_knn_graph", held_build)
    idx.search_batch(vecs[:1], 3)          # spawns the build, held
    assert started.wait(10)
    thread = co._graph_thread
    closer = threading.Thread(target=idx.close)
    closer.start()
    deadline = time.monotonic() + 10
    while co._graph_thread is not None and time.monotonic() < deadline:
        time.sleep(0.01)
    assert closer.is_alive()               # waits for the build
    gate.set()
    closer.join(10)
    assert not closer.is_alive() and not thread.is_alive()
    assert co._nbrs_h is None and co._ivf_dev is None and co._dev is None
    with pytest.raises(IndexError_):
        idx.search_batch(vecs[:1], 3)


# ----------------------------------------------------------- configuration

FULL_TOML = """
[server]
data_dir = "/srv/cortex"
http_addr = "127.0.0.1:9999"
warmup = false
sqlite_synchronous = "full"

[schema]
kinds = ["meeting-note"]
relations = ["blocks"]

[embedding]
model = "hash"
dimension = 128
index = "ivf"
ivf_nlist = 64

[auto_linker]
interval_secs = 30

[briefing]
max_items_per_section = 7
max_total_items = 40
max_chars = 6000
recent_window_hours = 24
cache_ttl_secs = 120
include_contradictions = false
min_importance = 0.25
exclude_kinds = ["runbook"]

[ingest.file]
enabled = true
watch_dir = "./in"

[observability]
sse_buffer = 512

[retention]
default_ttl_days = 365
grace_days = 14
protect_with_inbound_edges = false
max_nodes = { limit = 100000, strategy = "oldest_lowest_importance" }

[retention.by_kind]
observation = 90
event = { ttl_days = 30, min_score = 0.2 }

[security]
encryption_at_rest = false

[[webhooks]]
url = "http://localhost:1/hook"
events = ["node.created"]

[[plugins]]
path = "plugins/rule.py"
type = "linker_rule"

[prompt_rollback]
enabled = false
monitoring_window = 30
min_samples_before_check = 7
correction_rate_warning = 1.5
consecutive_negative_limit = 4
cooldown_base_hours = 2
max_rollbacks_before_quarantine = 5

[score_decay]
daily_rate = 0.03

[write_gate]
enabled = true
conflict_threshold = 0.8
duplicate_threshold = 0.95
min_title_length = 8
min_body_length = 25
require_tags_above_importance = 0.9
require_body_length_for_importance = false

[write_gate.overrides.observation]
min_body_length = 10

[write_gate.overrides.decision]
conflict_threshold = 0.75

[schemas.decision]
required_fields = ["rationale"]

[schemas.decision.fields.priority]
type = "number"
min = 1
max = 5

[schemas.decision.fields.status]
type = "string"
allowed_values = ["open", "done"]
"""


def test_every_section_parses_as_the_reference(tmp_path):
    path = tmp_path / "cortex.toml"
    path.write_text(FULL_TOML)
    ref, port = JaxConfig.load(str(path)), CortexConfig.load(str(path))
    ref.validate()
    port.validate()
    want, got = dataclasses.asdict(ref), dataclasses.asdict(port)
    assert set(got) == set(want)
    for section in want:
        assert got[section] == want[section], section
    assert got["retention"]["by_kind"]["event"] == {"ttl_days": 30.0,
                                                    "min_score": 0.2}
    assert got["write_gate"]["overrides"]["decision"][
        "conflict_threshold"] == 0.75
    assert got["schemas"]["decision"]["fields"]["priority"]["max"] == 5


@pytest.mark.parametrize("toml", [
    "[briefing]\nmax_total_items = 0\n",
    "[[webhooks]]\nevents = [\"node.created\"]\n",
    "[embedding]\nindex = \"hnsw\"\n",
    "[embedding]\nivf_spill = 1.5\n",
    "[auto_linker.similarity]\nauto_link_threshold = 1.5\n",
])
def test_invalid_values_raise_the_reference_errors(toml, tmp_path):
    path = tmp_path / "bad.toml"
    path.write_text(toml)
    with pytest.raises(JaxConfigError) as want:
        JaxConfig.load(str(path)).validate()
    with pytest.raises(ConfigError) as got:
        CortexConfig.load(str(path)).validate()
    assert str(got.value) == str(want.value)


def test_unparsable_retention_raises_as_the_reference():
    bad = {"retention": {"max_nodes": {"strategy": "x"}}}
    with pytest.raises(KeyError):
        JaxConfig.from_dict(bad)
    with pytest.raises(KeyError):
        CortexConfig.from_dict(bad)


# ---------------------------------------------------------- state carried


def reference_state(path):
    """A SQLite file written by the reference: nodes (some aged past the
    retention TTLs, with edges), prompts with versions, a branch and a
    deployment rolled back, audit rows, and a tombstone past the grace
    window."""
    jcfg, _ = configs("flat", retention=True)
    cx = JaxCortex.open(path, jcfg)
    rng = np.random.default_rng(23)
    now = time.time()
    nodes = [topic_node(i, rng) for i in range(60)]
    for i, n in enumerate(nodes):
        if i % 3 == 0:
            aged(n, 120.0, 60.0, now)
    nodes.append(JaxNode.new("agent", "Kai the assistant",
                             "Agent kai handles release work",
                             JaxSource(agent="kai"), 0.8))
    cx.store_batch(nodes)
    for i in range(0, 40, 4):
        cx.create_edge(JaxEdge.new(nodes[i + 1].id, nodes[i].id,
                                   "informed_by", 0.8, JaxProv.manual("t")))
        cx.create_edge(JaxEdge.new(nodes[i + 2].id, nodes[-1].id,
                                   "applies_to", 0.8, JaxProv.manual("t")))
    cx.delete_node(nodes[5].id)
    stone = cx.storage.get_node(nodes[5].id)
    stone.updated_at = now - 50 * DAY
    cx.storage.put_node(stone)
    cx.audit.record("export", nodes[7].id, actor="ops",
                    details={"format": "jsonl"})

    def content(v):
        return JaxPromptContent(slug="helper", prompt_type="persona",
                                sections={"v": v, "tone": "brief"})

    res = cx.prompts
    res.create_prompt(content(1))
    v2 = res.create_version("helper", "main", content(2))
    res.create_branch("helper", "main", "exp", base_version=1)
    mon = cx.rollback_monitor
    mon.record_deployment("helper", "main", 2, v2, "kai",
                          [(0.1, 0.8), (0.12, 0.75), (0.11, 0.82)])
    result = None
    for i in range(5):
        obs = JaxNode.new("observation", f"Interaction observation {i}",
                          "Observed interaction outcome details here",
                          JaxSource(agent="kai"), 0.5)
        cx.store(obs)
        result = result or mon.process_observation(obs.id, v2, 0.12, 0.75,
                                                   0.2)
    assert result is not None                # rolled back to version 1
    cx.close()


def state_view(cx):
    b = cx.briefing_full("kai")
    heads = {br: cx.prompts.find_head("helper", br) for br in ("main",
                                                              "exp")}
    return {
        "briefing": [(s.title, sorted(n.id for n in s.nodes))
                     for s in b.sections],
        "query": [n.id for n in cx.query("kind:fact,event")],
        "prompts": [dataclasses.asdict(p)
                    for p in cx.prompts.list_all_prompts()],
        "resolved": {br: dataclasses.asdict(cx.prompts.resolve(h))
                     for br, h in heads.items()},
        "versions": [dataclasses.asdict(v) for v in
                     cx.prompts.list_versions("helper", "main")],
        "rollback": dataclasses.asdict(
            cx.rollback_monitor.get_status("helper", "main")),
        "audit": [dataclasses.asdict(e) for e in cx.audit.query(limit=500)],
    }


def test_reference_state_opens_in_the_port(tmp_path):
    src = str(tmp_path / "ref.db")
    reference_state(src)
    for name in ("jax.db", "torch.db"):
        shutil.copy(src, tmp_path / name)
    jcfg, tcfg = configs("flat", retention=True)
    ref = JaxCortex.open(str(tmp_path / "jax.db"), jcfg)
    port = Cortex.open(str(tmp_path / "torch.db"), tcfg, device="cpu")
    want, got = state_view(ref), state_view(port)
    assert got == want
    assert want["rollback"]["rollback_count"] == 1
    assert "export" in {e["action"] for e in want["audit"]}
    assert len(want["prompts"]) == 2
    swept = ref.run_retention()
    assert port.run_retention() == swept and swept[0] > 0
    assert swept[1] == 1                     # the backdated tombstone
    assert live_ids(port) == live_ids(ref)
    ref.close()
    port.close()
