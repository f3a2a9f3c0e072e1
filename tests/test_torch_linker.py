"""The port's auto-linker and edge decay held against cortex_tpu on the
same seeded inputs.

cortex_tpu_torch keeps copies of the reference's tracing spans,
similarity config and linker modules (config, metrics, rules, dedup,
auto_linker); its decay sweep (ops/decay.py, D1 on the card) and decay
engine are torch. Here:

  * the copies agree with the reference line for line but for imports;
  * the sweep: the port's decay_sweep (its plain version on the CPU)
    and decay_sweep_host against the reference's jitted decay_sweep (on
    JAX's CPU backend) and its decay_sweep_host, over 100,003 seeded
    edges with days <= 0, exempt rows, importance * shield = 1 (no
    decay) and weights that land exactly on each threshold;
  * apply_decay on the same seeded SQLite store in both packages, above
    and below DEVICE_SWEEP_MIN_EDGES, in-process and through the
    out-of-process worker: the same weights, deletions, counts and
    audit rows;
  * run_cycle through both packages' Cortex (memory and SQLite, the
    exact and the quant search path) over 4 cycles that run the scan,
    the candidate search, the link rules, decay and dedup: the same
    edges, metrics, cursors and dedup pairs after each cycle;
  * bulk_import feeding the same cursor, a reference linker's state
    resumed by the port, and the [auto_linker] TOML section;
  * the worker's audit flag, the one named deviation from the
    reference, and a device probe that fails loudly.

Tolerances. new_w is held in ulps (units in the last place of float32).
The two numpy-order passes (the port's plain torch version and the
reference's host pass) round the same operations in the same order and
differ only in exp: torch's within 1 ulp of the exact value, numpy's
within 2 (measured here against a float64 exp), so 3 * 2^-23 apart
relative, plus the product's rounding, 2^-23: within HOST_ULPS = 8 ulps
(a product low in its binade has ulps of 2^-24 relative). The
reference's XLA program contracts 1 - importance * shield into a fused
multiply-add, so eff and x = -eff * days differ by a few ulps, which
exp turns into a relative error of |x| times that: within
HOST_ULPS + 5 |x| ulps. The masks are equal but on rows whose new_w
lies within that bound of a threshold (or of the old weight, for
`changed`). Linker edge weights are cosine scores, held to 1e-5.
"""

import copy
import dataclasses
import inspect
import re
import shutil
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cortex_tpu.linker.dedup as jax_dedup
import cortex_tpu.utils.tracing as jax_tracing
from cortex_tpu import Cortex as JaxCortex
from cortex_tpu.config import CortexConfig as JaxConfig
from cortex_tpu.linker.config import DecayConfig as JaxDecayConfig
from cortex_tpu.linker.decay import DecayEngine as JaxDecayEngine
from cortex_tpu.ops import decay as jax_decay
from cortex_tpu.storage import MemoryStorage as JaxMemory
from cortex_tpu.storage import SqliteStorage as JaxSqlite
from cortex_tpu.types import Edge as JaxEdge
from cortex_tpu.types import EdgeProvenance as JaxProv
from cortex_tpu.types import Node as JaxNode
from cortex_tpu.types import Source as JaxSource
import cortex_tpu_torch.linker.dedup as port_dedup
import cortex_tpu_torch.utils.tracing as port_tracing
from cortex_tpu_torch import Cortex
from cortex_tpu_torch.config import CortexConfig
from cortex_tpu_torch.linker import auto_linker
from cortex_tpu_torch.linker.config import DecayConfig
from cortex_tpu_torch.linker.decay import DecayEngine
from cortex_tpu_torch.ops import decay as port_decay
from cortex_tpu_torch.storage import MemoryStorage, SqliteStorage
from cortex_tpu_torch.types import Edge, EdgeProvenance, Node, Source

REPO = Path(__file__).resolve().parent.parent
COPIES = ("vector/config.py", "linker/config.py", "linker/metrics.py",
          "linker/rules.py", "linker/dedup.py", "linker/auto_linker.py",
          "linker/__init__.py")
TRACING = ("SpanStats", "stats", "reset_stats", "span", "timed")
HOST_ULPS = 8
ARG_ULPS = 5            # ulps of new_w per unit of |x| (XLA's fused eff)
WEIGHT_ATOL = 1e-5
DIM = 64
DAY = 86400.0


def _without_imports(text):
    return [line for line in text.splitlines()
            if not re.match(r"\s*(from|import)\s", line)]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_matches_reference(rel):
    ref = (REPO / "cortex_tpu" / rel).read_text()
    port = (REPO / "cortex_tpu_torch" / rel).read_text()
    assert _without_imports(port) == _without_imports(ref)


@pytest.mark.parametrize("name", TRACING)
def test_tracing_copy_matches_reference(name):
    assert inspect.getsource(getattr(port_tracing, name)) == \
        inspect.getsource(getattr(jax_tracing, name))
    # the port's spans feed the port's table, never the reference's
    assert getattr(port_tracing, name) is not getattr(jax_tracing, name)


# ------------------------------------------------------------ the sweep


def ulps(a, b):
    """|a - b| in float32 ulps, for non-negative float32 arrays."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


def arg_of(days, imp, rate, shield):
    """|x| = eff_rate * max(days, 0), in float64, per row."""
    eff = rate * (1.0 - imp.astype(np.float64) * shield)
    return np.abs(eff * np.maximum(days.astype(np.float64), 0.0))


def sweep_inputs(n, seed, shield):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.0, 1.0, n).astype(np.float32)
    days = rng.uniform(0.0, 400.0, n).astype(np.float32)
    days[rng.random(n) < 0.05] = -rng.uniform(0.0, 5.0)
    days[::97] = 0.0
    imp = rng.uniform(0.0, 1.0, n).astype(np.float32)
    exempt = rng.random(n) < 0.1
    if shield == 1.0:
        imp[::13] = 1.0                        # importance * shield = 1
    # exactly on each threshold: exp(-x) rounds to 1 for x < 2^-25
    for j, thr in enumerate((0.05, 0.1)):
        w[j::101] = np.float32(thr)
        days[j::101] = 1e-6
    # just above and below the thresholds after a short decay
    near = rng.choice(np.flatnonzero(np.arange(n) % 101 > 1), 400,
                      replace=False)
    w[near] = np.float32(0.05) * (1 + rng.uniform(-1e-5, 1e-5, 400))
    days[near] = rng.uniform(0.0, 0.01, 400)
    return w, days, imp, exempt


def reference_sweep(w, days, imp, exempt, cfg):
    rate, shield, dthr, pthr = cfg
    out = jax_decay.decay_sweep(
        jnp.asarray(w), jnp.asarray(days), jnp.asarray(imp),
        jnp.asarray(exempt), jnp.float32(rate), jnp.float32(shield),
        jnp.float32(dthr), jnp.float32(pthr))
    return tuple(np.asarray(o) for o in out)


def assert_sweeps_agree(got, want, tol, thresholds, old_w):
    """new_w within `tol` ulps per row; masks equal except on rows whose
    new_w lies within tol of a threshold (delete, prune) or of the old
    weight (changed). Returns the count of rows whose masks differ."""
    d = ulps(got[0], want[0])
    assert (d <= tol).all(), (int(d.max()), np.flatnonzero(d > tol)[:5])
    near_thr = np.zeros(len(old_w), bool)
    for thr in thresholds:
        near_thr |= ulps(got[0], np.float32(thr)) <= tol
    near_old = ulps(got[0], old_w) <= tol
    differ = np.zeros(len(old_w), bool)
    for k, near in ((1, near_thr), (2, near_thr), (3, near_old)):
        diff = got[k] != want[k]
        assert not (diff & ~near).any(), (k, np.flatnonzero(diff & ~near)[:5])
        differ |= diff
    return int(differ.sum())


CONFIGS = {"default": (0.01, 0.8, 0.05, 0.1),
           "full_shield": (0.01, 1.0, 0.05, 0.1)}


@pytest.mark.parametrize("name", CONFIGS)
def test_sweep_matches_reference(name):
    cfg = CONFIGS[name]
    rate, shield, dthr, pthr = cfg
    n = 100_003
    w, days, imp, exempt = sweep_inputs(n, seed=3, shield=shield)
    t = port_decay.decay_sweep(
        torch.from_numpy(w), torch.from_numpy(days), torch.from_numpy(imp),
        torch.from_numpy(exempt), daily_rate=rate, shield=shield,
        delete_threshold=dthr, prune_threshold=pthr)
    port = tuple(x.numpy() for x in t)
    assert [x.dtype for x in port] == [np.float32, bool, bool, bool]
    port_host = port_decay.decay_sweep_host(w, days, imp, exempt, *cfg)
    ref_host = jax_decay.decay_sweep_host(w, days, imp, exempt, *cfg)
    ref = reference_sweep(w, days, imp, exempt, cfg)
    # the host twins are one function
    for a, b in zip(port_host, ref_host):
        np.testing.assert_array_equal(a, b)
    x = arg_of(days, imp, rate, shield)
    xla_tol = HOST_ULPS + ARG_ULPS * x
    near = [assert_sweeps_agree(port, ref_host, HOST_ULPS, (dthr, pthr), w),
            assert_sweeps_agree(port, ref, xla_tol, (dthr, pthr), w),
            assert_sweeps_agree(port_host, ref, xla_tol, (dthr, pthr), w)]
    assert max(near) <= n // 1000, near
    # the active rows placed exactly on a threshold stay on it: not
    # deleted (not below 0.05), pruned (below 0.1), unchanged
    on = np.arange(0, n, 101)
    on = on[~exempt[on]]
    assert len(on) > 800
    assert (port[0][on] == np.float32(dthr)).all()
    assert not port[1][on].any() and port[2][on].all()
    assert not port[3][on].any()
    assert not port[2][on + 1].any()          # on 0.1: not below it
    # inactive rows keep their weight and raise no flag
    idle = exempt | (days <= 0)
    assert (port[0][idle] == w[idle]).all()
    assert not (port[1] | port[2] | port[3])[idle].any()
    if shield == 1.0:
        flat = slice(0, None, 13)
        np.testing.assert_array_equal(port[0][flat], w[flat])


def test_sweep_rejects_bad_arguments():
    w = torch.zeros(8)
    with pytest.raises(ValueError, match="exempt"):
        port_decay.decay_sweep(w, w, w, torch.zeros(8), daily_rate=0.01,
                               shield=0.8, delete_threshold=0.05,
                               prune_threshold=0.1)
    with pytest.raises(ValueError, match="days"):
        port_decay.decay_sweep(w, torch.zeros(7), w,
                               torch.zeros(8, dtype=torch.bool),
                               daily_rate=0.01, shield=0.8,
                               delete_threshold=0.05, prune_threshold=0.1)


def test_device_probe_failure_raises(monkeypatch):
    """No silent fallback: where the reference's probe reports 0 B/s for
    a failing device and sweeps on the host, the port's raises."""
    def broken(payload, device):
        raise RuntimeError("device lost")

    monkeypatch.setattr(port_decay, "_measured_bw", {})
    monkeypatch.setattr(port_decay, "_round_trip", broken)
    assert port_decay.use_device_sweep(1000, "cuda") is False   # host
    with pytest.raises(RuntimeError, match="device lost"):
        port_decay.use_device_sweep(port_decay.DEVICE_SWEEP_MIN_EDGES,
                                    "cuda")
    # a CPU device crosses no link and needs no probe
    assert port_decay.use_device_sweep(
        port_decay.DEVICE_SWEEP_MIN_EDGES, "cpu") is True


# -------------------------------------------------------- apply_decay


def decay_store_rows(n_edges, seed):
    """(nodes, edges) as dicts: 2,000 nodes with seeded importance, and
    n_edges distinct (from, to, relation) triples with weights,
    updated_at 0-400 days before NOW and 20 % manual provenance."""
    rng = np.random.default_rng(seed)
    n_nodes = 2000
    nodes = [dict(id=f"n{i}", importance=float(rng.uniform(0.0, 1.0)))
             for i in range(n_nodes)]
    rels = ("related_to", "led_to", "uses", "supports")
    pick = rng.choice(n_nodes * (n_nodes - 1) * len(rels), n_edges,
                      replace=False)
    edges = []
    for j, p in enumerate(pick.tolist()):
        r, rest = divmod(p, n_nodes * (n_nodes - 1))
        a, b = divmod(rest, n_nodes - 1)
        b += b >= a
        edges.append(dict(
            id=f"e{j}", from_id=f"n{a}", to_id=f"n{b}", relation=rels[r],
            weight=float(np.float32(rng.uniform(0.02, 1.0))),
            manual=bool(rng.random() < 0.2),
            updated_at=NOW - float(rng.uniform(-1.0, 400.0)) * DAY))
    return nodes, edges


NOW = 1_760_000_000.0


def fill_store(store, rows, pkg):
    NodeT, EdgeT, Prov, SourceT = pkg
    nodes, edges = rows
    store.bulk_put_nodes([
        NodeT(id=n["id"], kind="fact", title=n["id"], body="",
              source=SourceT(agent="a"), importance=n["importance"],
              created_at=NOW - 500 * DAY, updated_at=NOW - 500 * DAY)
        for n in nodes])
    store.bulk_put_edges([
        EdgeT(id=e["id"], from_id=e["from_id"], to_id=e["to_id"],
              relation=e["relation"], weight=e["weight"],
              provenance=(Prov.manual("a") if e["manual"]
                          else Prov.imported("seed")),
              created_at=e["updated_at"], updated_at=e["updated_at"])
        for e in edges])


PORT_TYPES = (Node, Edge, EdgeProvenance, Source)
JAX_TYPES = (JaxNode, JaxEdge, JaxProv, JaxSource)


def store_state(path):
    """{edge id: weight} and the audit rows (action, target, actor) of
    a SQLite file, read with sqlite3."""
    import sqlite3
    con = sqlite3.connect(path)
    try:
        w = dict(con.execute("SELECT id, weight FROM edges"))
        audit = sorted(con.execute(
            "SELECT action, target_id, actor FROM audit "
            "WHERE action = 'edge_deleted'"))
    finally:
        con.close()
    return w, audit


def expected_tol(rows, cfg):
    """Per-edge ulp bound of a port sweep against a reference one."""
    nodes, edges = rows
    imp = {n["id"]: n["importance"] for n in nodes}
    days = np.array([(NOW - e["updated_at"]) / DAY for e in edges],
                    np.float32)
    mi = np.array([max(imp[e["from_id"]], imp[e["to_id"]]) for e in edges],
                  np.float32)
    x = arg_of(days, mi, cfg.daily_decay_rate, cfg.importance_shield)
    return {e["id"]: HOST_ULPS + ARG_ULPS * x[j]
            for j, e in enumerate(edges)}


@pytest.mark.parametrize("venue", ["inline", "worker"])
@pytest.mark.parametrize("n_edges", [70_000, 5_000])
def test_apply_decay_matches_reference(tmp_path, venue, n_edges):
    rows = decay_store_rows(n_edges, seed=n_edges)
    paths = {}
    for name, pkg, Store in (("jax", JAX_TYPES, JaxSqlite),
                             ("port", PORT_TYPES, SqliteStorage)):
        paths[name] = str(tmp_path / f"{name}.db")
        s = Store(paths[name])
        fill_store(s, rows, pkg)
        s.close()
    js, ps = JaxSqlite(paths["jax"]), SqliteStorage(paths["port"])
    jeng = JaxDecayEngine(js, JaxDecayConfig())
    peng = DecayEngine(ps, DecayConfig(), device="cpu")
    calls = []
    real = peng._sweep_arrays
    peng._sweep_arrays = lambda *a: calls.append(len(a[0])) or real(*a)
    if venue == "inline":
        want = jeng.apply_decay(NOW)
        got = peng.apply_decay(NOW)
        # the port's chunk took the device path at and above the bound
        assert calls == [n_edges]
        assert port_decay.use_device_sweep(n_edges, peng.device) == \
            (n_edges >= port_decay.DEVICE_SWEEP_MIN_EDGES)
    else:
        want = jeng.apply_decay_isolated(paths["jax"], NOW)
        got = peng.apply_decay_isolated(paths["port"], NOW)
    js.close()
    ps.close()
    assert got == want and want[1] > 0 and want[0] > 0
    jw, jaudit = store_state(paths["jax"])
    pw, paudit = store_state(paths["port"])
    assert pw.keys() == jw.keys()                  # the same deletions
    assert len(pw) == n_edges - want[1]
    tol = expected_tol(rows, DecayConfig())
    bad = [eid for eid, w in pw.items()
           if ulps(np.float32(w), np.float32(jw[eid])) > tol[eid]]
    assert not bad, bad[:5]
    assert paudit == jaudit and len(paudit) == want[1]


def test_worker_honours_the_audit_flag(tmp_path):
    """The named deviation: the reference's worker opens the store with
    audit_enabled=True whatever the store says (its decay_worker.py:51),
    so a store kept without an audit log gains audit rows from each
    out-of-process sweep. The port's worker opens it with the store's
    own flag and writes none."""
    rows = decay_store_rows(3000, seed=5)
    got = {}
    for name, pkg, Store, Engine, cfg in (
            ("jax", JAX_TYPES, JaxSqlite, JaxDecayEngine, JaxDecayConfig()),
            ("port", PORT_TYPES, SqliteStorage, DecayEngine, DecayConfig())):
        path = str(tmp_path / f"{name}.db")
        s = Store(path, audit_enabled=False)
        fill_store(s, rows, pkg)
        eng = (Engine(s, cfg) if name == "jax"
               else Engine(s, cfg, device="cpu"))
        pruned, deleted = eng.apply_decay_isolated(path, NOW)
        s.close()
        got[name] = (deleted, store_state(path)[1])
    assert got["jax"][0] == got["port"][0] > 0
    assert len(got["jax"][1]) == got["jax"][0]     # audit rows written
    assert got["port"][1] == []                    # none: audit is off


# ------------------------------------------------------------ run_cycle


def linker_nodes(n, seed, pkg):
    """n nodes with 64-d embeddings in 40 clusters (spread 0.15-0.9, so
    cluster mates score ~0.55-0.98), some near-duplicates, 12
    agents, sessions, tags, negations, created_at over 30 days."""
    NodeT, _, _, SourceT = pkg
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((40, DIM))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    kinds = ("fact", "event", "decision", "observation", "pattern")
    tags = [f"t{i}" for i in range(12)]
    out = []
    for i in range(n):
        c = int(rng.integers(0, 40))
        if i >= 20 and rng.random() < 0.05:        # near-duplicate
            x = np.asarray(out[int(rng.integers(0, i))].embedding)
            x = x + 0.04 * rng.standard_normal(DIM) / DIM ** 0.5
        else:
            s = rng.uniform(0.15, 0.9)
            x = centers[c] + s * rng.standard_normal(DIM) / DIM ** 0.5
        x = (x / np.linalg.norm(x)).astype(np.float32)
        neg = " not any more" if rng.random() < 0.1 else ""
        t = NOW - float(rng.uniform(0.0, 30.0)) * DAY
        out.append(NodeT(
            id=f"node{seed}-{i:04d}", kind=kinds[i % 5],
            title=f"entry {i} on topic {c}",
            body=f"body of entry {i} about topic {c}{neg}",
            tags=sorted(rng.choice(tags, int(rng.integers(0, 4)),
                                   replace=False).tolist()),
            embedding=x.tolist(),
            source=SourceT(agent=f"agent{i % 12}",
                           session=f"s{int(rng.integers(0, 6))}"),
            importance=float(rng.uniform(0.1, 0.95)),
            created_at=t, updated_at=t))
    return out


def old_edges(nodes, n, seed, pkg):
    """n edges between the nodes, updated 0-400 days ago (so decay
    prunes and deletes), 20 % manual."""
    _, EdgeT, Prov, _ = pkg
    rng = np.random.default_rng(seed)
    out, seen = [], set()
    while len(out) < n:
        a, b = (int(v) for v in rng.integers(0, len(nodes), 2))
        if a == b or (a, b) in seen:
            continue
        seen.add((a, b))
        t = time.time() - float(rng.uniform(0.0, 400.0)) * DAY
        out.append(EdgeT(
            id=f"old{len(out)}", from_id=nodes[a].id, to_id=nodes[b].id,
            relation="supports",
            weight=float(rng.uniform(0.05, 1.0)),
            provenance=(Prov.manual("a") if rng.random() < 0.2
                        else Prov.imported("seed")),
            created_at=t, updated_at=t))
    return out


def linker_configs(path):
    out = []
    for cfg in (JaxConfig(), CortexConfig()):
        cfg.embedding.model = "hash-64"
        cfg.embedding.dimension = DIM
        cfg.embedding.search_path = path
        al = cfg.auto_linker
        al.max_nodes_per_cycle = 200
        al.decay_every_n_cycles = 2
        al.dedup_every_n_cycles = 3
        out.append(cfg)
    return out


class LinkerPair:
    """One seeded store in each package, with a Cortex over each."""

    def __init__(self, kind, path, tmp_path, n=600, seed=7):
        self.kind, self.tmp_path = kind, tmp_path
        self.jcfg, self.pcfg = linker_configs(path)
        self.open()
        jn = linker_nodes(n, seed, JAX_TYPES)
        self.ref.store_batch(jn)
        self.port.store_batch(linker_nodes(n, seed, PORT_TYPES))
        old = old_edges(jn, 150, seed, JAX_TYPES)
        self.ref.storage.bulk_put_edges(old)
        self.port.storage.bulk_put_edges(
            [Edge.from_dict(e.to_dict()) for e in old])
        self.dedup = {"jax": [], "port": []}

    def open(self):
        if self.kind == "memory":
            self.ref = JaxCortex(JaxMemory(), self.jcfg)
            self.port = Cortex(MemoryStorage(), self.pcfg, device="cpu")
        else:
            self.ref = JaxCortex.open(str(self.tmp_path / "jax.db"),
                                      self.jcfg)
            self.port = Cortex.open(str(self.tmp_path / "port.db"),
                                    self.pcfg, device="cpu")

    def close(self):
        if self.kind == "sqlite":
            self.ref.close()
            self.port.close()


@pytest.fixture
def record_dedup(monkeypatch):
    """Record every dedup action both packages execute, in order."""
    seen = {"jax": [], "port": []}
    for name, mod in (("jax", jax_dedup), ("port", port_dedup)):
        real = mod.DedupScanner.execute_action

        def spy(self, pair, _real=real, _out=seen[name]):
            _out.append((pair.node_a, pair.node_b, pair.action, pair.keep,
                         pair.retire, pair.similarity))
            return _real(self, pair)
        monkeypatch.setattr(mod.DedupScanner, "execute_action", spy)
    return seen


def assert_same_dedup(seen):
    """The same pairs and actions in the same order; similarities are
    cosine scores, held to WEIGHT_ATOL."""
    want, got = seen["jax"], seen["port"]
    assert [w[:5] for w in want] == [g[:5] for g in got]
    np.testing.assert_allclose([g[5] for g in got], [w[5] for w in want],
                               atol=WEIGHT_ATOL)


def edge_set(storage):
    return sorted((e.from_id, e.to_id, e.relation, e.provenance.kind,
                   e.weight) for e in storage.all_edges())


def assert_same_edges(ref, port):
    want, got = edge_set(ref), edge_set(port)
    assert [w[:4] for w in want] == [g[:4] for g in got]
    np.testing.assert_allclose([g[4] for g in got], [w[4] for w in want],
                               atol=WEIGHT_ATOL)


def metrics_of(m):
    d = m.to_dict()
    for k in ("cycle_duration_secs",):
        d.pop(k)
    return d


def cursors_of(linker):
    return (linker.cursor, linker.cursor_id, linker.dedup_cursor,
            linker.dedup_cursor_id, linker.cycle_count)


@pytest.mark.parametrize("path", ["exact", "quant"])
@pytest.mark.parametrize("kind", ["memory", "sqlite"])
def test_run_cycle_matches_reference(tmp_path, kind, path, record_dedup):
    """4 cycles, each given the same clock in both packages, 30 days
    apart: the decay of an edge written seconds before a sweep rounds
    to its old weight or an ulp below it depending on the second, and
    so would the `changed` mask and the pruned count; a month is far
    from that."""
    pair = LinkerPair(kind, path, tmp_path)
    t0 = time.time()
    try:
        for cycle in range(4):
            now = t0 + 30 * DAY * (cycle + 1)
            want = metrics_of(pair.ref.linker.run_cycle(now))
            got = metrics_of(pair.port.linker.run_cycle(now))
            assert got == want, cycle
            assert cursors_of(pair.port.linker) == \
                cursors_of(pair.ref.linker)
            assert_same_edges(pair.ref.storage, pair.port.storage)
            assert_same_dedup(record_dedup)
        # every leg ran: links, decay (cycles 0 and 2), dedup (0 and 3)
        assert want["nodes_processed"] >= 400
        assert want["edges_created"] > 0 and want["edges_deleted"] > 0
        assert want["edges_pruned"] > 0 and want["duplicates_found"] > 0
        assert want["contradictions_found"] > 0
        assert len(record_dedup["port"]) == want["duplicates_found"]
        assert (pair.port.index.index_info()["resolved_path"]
                == "quant") == (path == "quant")
    finally:
        pair.close()


@pytest.mark.parametrize("advance", [True, False])
def test_bulk_import_feeds_the_same_cursor(tmp_path, advance):
    pair = LinkerPair("sqlite", "exact", tmp_path, n=150)
    try:
        assert metrics_of(pair.port.run_linker_cycle()) == \
            metrics_of(pair.ref.run_linker_cycle())
        later = [n for n in linker_nodes(120, 11, JAX_TYPES)]
        for n in later:
            n.created_at = n.updated_at = NOW + 40 * DAY + n.created_at % DAY
        got = pair.port.bulk_import(
            [Node.from_dict(n.to_dict()) for n in later],
            advance_linker_cursor=advance)
        want = pair.ref.bulk_import(copy.deepcopy(later),
                                    advance_linker_cursor=advance)
        assert got == want == {"nodes": 120, "edges": 0}
        # additive: a second import of the same rows inserts nothing
        assert pair.port.bulk_import(
            [Node.from_dict(n.to_dict()) for n in later[:5]],
            advance_linker_cursor=advance) == {"nodes": 0, "edges": 0}
        assert cursors_of(pair.port.linker) == cursors_of(pair.ref.linker)
        want = metrics_of(pair.ref.run_linker_cycle())
        got = metrics_of(pair.port.run_linker_cycle())
        assert got == want
        assert (want["cycle_nodes_processed"] == 0) == advance
        assert cursors_of(pair.port.linker) == cursors_of(pair.ref.linker)
        assert_same_edges(pair.ref.storage, pair.port.storage)
        assert all(n.id in pair.port.index for n in later)
    finally:
        pair.close()


def test_port_resumes_a_reference_linker(tmp_path, record_dedup):
    """State carried across: the linker's state is its cursors and cycle
    count in storage metadata, under the reference's keys. A SQLite
    file in which the reference's linker ran 2 cycles opens in the
    port, whose linker resumes at the same cursor; its third cycle
    equals the reference's third on a byte copy of the file."""
    jcfg, pcfg = linker_configs("exact")
    path = str(tmp_path / "shared.db")
    ref = JaxCortex.open(path, jcfg)
    ref.store_batch(linker_nodes(500, 9, JAX_TYPES))
    ref.run_linker_cycle()
    ref.run_linker_cycle()
    state = cursors_of(ref.linker)
    ref.close()
    record_dedup["jax"].clear()
    copy_path = str(tmp_path / "copy.db")
    shutil.copyfile(path, copy_path)
    port = Cortex.open(path, pcfg, device="cpu")
    ref = JaxCortex.open(copy_path, jcfg)
    try:
        assert state[4] == 2 and state[0] > 0
        assert cursors_of(port.linker) == cursors_of(ref.linker) == state
        assert port.linker.metrics.cursor == state[0]
        want = metrics_of(ref.run_linker_cycle())
        got = metrics_of(port.run_linker_cycle())
        assert got == want and want["cycle_nodes_processed"] > 0
        assert cursors_of(port.linker) == cursors_of(ref.linker)
        assert_same_edges(ref.storage, port.storage)
        assert_same_dedup(record_dedup)
    finally:
        port.close()
        ref.close()


def test_cortex_wires_the_linker():
    cx = Cortex.in_memory(linker_configs("exact")[1], device="cpu")
    assert isinstance(cx.linker, auto_linker.AutoLinker)
    assert cx.linker.decay_engine.device == torch.device("cpu")
    assert cx.linker.persist_lock is cx._persist_lock
    assert not hasattr(cx, "decay_engine")
    cx._index_pair_failed()
    assert cx._index_diverged and not cx._index_base_synced


# ------------------------------------------------------------ config


TOML = """
[embedding]
model = "hash-64"
dimension = 64

[auto_linker]
interval_secs = 12.5
max_nodes_per_cycle = 300
max_edges_per_cycle = 900
max_edges_per_node = 20
candidate_k = 40
decay_every_n_cycles = 7
dedup_every_n_cycles = 11
generic_content_threshold = 15
run_on_startup = false
legacy_rules_enabled = true

[auto_linker.similarity]
auto_link_threshold = 0.7
dedup_threshold = 0.95
contradiction_threshold = 0.85
auto_link_k = 12

[auto_linker.decay]
daily_decay_rate = 0.02
prune_threshold = 0.2
delete_threshold = 0.06
importance_shield = 0.5
access_reinforcement_days = 3.0
exempt_manual = false

[[auto_linker.rules]]
name = "decision-informs-pattern"
from_kind = "decision"
to_kind = "pattern"
relation = "informed_by"
weight = 0.6
bidirectional = true
[auto_linker.rules.condition]
type = "min_similarity"
threshold = 0.7
"""


@pytest.mark.parametrize("text", ["", TOML], ids=["defaults", "full"])
def test_auto_linker_toml_matches_reference(tmp_path, text):
    p = tmp_path / "cortex.toml"
    p.write_text(text)
    want = dataclasses.asdict(JaxConfig.load(str(p)).auto_linker)
    got = dataclasses.asdict(CortexConfig.load(str(p)).auto_linker)
    assert got == want
    if text:
        assert got["rules"][0]["condition"]["threshold"] == 0.7
        assert got["decay"]["exempt_manual"] is False
        assert got["embedding_model"] == "hash-64"
