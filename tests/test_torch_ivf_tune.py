"""The port's recall-target nprobe tuner ([embedding] ivf_target_recall)
against the JAX package's, on the CPU.

Every single-device case of tests/test_ivf_tune.py runs on the port,
the snapshot-file ones as carry-overs of the reference's state() through
IvfCorpus.load_jax_state (the files: tests/test_torch_snapshot.py). Parity:
from the same state, the port's tuner picks the reference's nprobe with
the reference's probe-hit curve (both count hits over the same layout:
equal to the last bit), and its per-chunk truth (K1 over the flattened
layout, ops/similarity.py::quant_candidates) equals the reference's
_tune_chunk_topk. The one named deviation (ROADMAP queue C): the port's
_measure_delivered counts a sampled query with no candidates as all
misses where the reference skips it.
"""

import threading
import time as _t

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cortex_tpu.ops.similarity import NEG_INF
from cortex_tpu.vector import BruteForceIndex, TpuIvfIndex
from cortex_tpu.vector.ivf import _tune_chunk_topk
from cortex_tpu_torch.ops.similarity import (quant_candidates,
                                             quantize_queries)
from cortex_tpu_torch.vector import TorchIvfIndex
from cortex_tpu_torch.vector.ivf import TUNE_TRUTH_K, IvfCorpus

DIM = 32


def smooth(n=800, seed=2, dim=DIM):
    """Overlapping-cluster corpus: neighbours straddle cluster
    boundaries, so probe-hit keeps rising with nprobe."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(6, dim)).astype(np.float32)
    asg = rng.integers(0, 6, n)
    v = (centers[asg]
         + 1.5 * rng.normal(size=(n, dim)).astype(np.float32))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v


def blocky(n=800, seed=3, dim=DIM):
    """Tight isolated clusters: a query's true top-10 is its own block."""
    rng = np.random.default_rng(seed)
    g = n // 8
    centers = rng.normal(size=(g, dim)).astype(np.float32)
    v = (np.repeat(centers, 8, axis=0)[:n]
         + 0.02 * rng.normal(size=(n, dim)).astype(np.float32))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v


def build(vecs, **kw):
    ids = [f"n{i:04d}" for i in range(len(vecs))]
    idx = TorchIvfIndex(vecs.shape[1], device="cpu", **kw)
    idx.insert_batch(ids, vecs)
    idx._corpus.sync()                        # train the layout now
    bf = BruteForceIndex(vecs.shape[1])
    for i, nid in enumerate(ids):
        bf.insert(nid, vecs[i])
    return idx, bf


def recall_at10(idx, bf, q):
    got = idx.search_batch(q, 10)
    want = bf.search_batch(q, 10)
    hit = tot = 0
    for g, w in zip(got, want):
        gs = {i for i, _ in g if i}
        ws = {i for i, _ in w if i}
        hit += len(gs & ws)
        tot += len(ws)
    return hit / max(1, tot)


def reference_state(vecs, **kw):
    """A trained reference index's state(), the tuner's keys included
    when it tuned."""
    ids = [f"n{i:04d}" for i in range(len(vecs))]
    ref = TpuIvfIndex(vecs.shape[1], graph_degree=0, **kw)
    ref.insert_batch(ids, vecs)
    ref._corpus.sync()
    return ref, ref._corpus.state()


def loaded_pair(tmp_path, st, **kw):
    """(reference index loaded from a snapshot of st, port index loaded
    from st): the same layout slot for slot, each tuned (or carried) by
    its own package at its first sync."""
    ref = TpuIvfIndex(DIM, graph_degree=0, **kw)
    path = str(tmp_path / "ivf.npz")
    ref.write_snapshot(path, st)
    ref.load(path)
    port = TorchIvfIndex(DIM, graph_degree=0, device="cpu", **kw)
    port._corpus.load_jax_state(st)
    ref._corpus.sync()
    port._corpus.sync()
    return ref, port


TUNER_KEYS = ("ivf_nprobe_tuned", "ivf_tune_curve", "ivf_cand_boost",
              "ivf_delivered")


class TestTunerDirection:
    def test_smooth_geometry_tunes_above_auto(self):
        idx, bf = build(smooth(), nlist=64, target_recall=0.95,
                        graph_degree=0)
        co = idx._corpus
        c = co._centroids_h.shape[0]
        assert co._nprobe_tuned > max(8, c // 8)
        assert recall_at10(idx, bf, smooth(32, seed=9)) >= 0.85

    def test_blocky_geometry_tunes_at_or_below_auto(self):
        idx, _ = build(blocky(), nlist=64, target_recall=0.95,
                       graph_degree=0)
        co = idx._corpus
        c = co._centroids_h.shape[0]
        assert 0 < co._nprobe_tuned <= max(8, c // 8)

    def test_target_met_on_tuner_sample(self):
        vecs = smooth()
        idx, bf = build(vecs, nlist=64, target_recall=0.9, graph_degree=0)
        assert recall_at10(idx, bf, vecs[::37][:24]) >= 0.8


class TestTunerPrecedence:
    def test_explicit_nprobe_wins(self):
        idx, _ = build(smooth(), nlist=64, nprobe=5, target_recall=0.99,
                       graph_degree=0)
        co = idx._corpus
        assert co._nprobe_tuned == 0
        assert co._nprobe(co._centroids_h.shape[0]) == 5

    def test_target_zero_disables(self):
        idx, _ = build(smooth(), nlist=64, graph_degree=0)
        co = idx._corpus
        c = co._centroids_h.shape[0]
        assert co._nprobe_tuned == 0
        assert co._nprobe(c) == max(8, c // 8)

    def test_tiny_corpus_skips(self):
        idx, _ = build(smooth(24), nlist=4, target_recall=0.9,
                       graph_degree=0)
        assert idx._corpus._nprobe_tuned == 0

    def test_ladder_membership(self):
        idx, _ = build(smooth(), nlist=64, target_recall=0.97,
                       graph_degree=0)
        co = idx._corpus
        c = co._centroids_h.shape[0]
        ladder = ({max(8, c >> i) for i in range(6, 0, -1)}
                  | {(3 * c) // 4, c})
        assert co._nprobe_tuned in ladder

    def test_curve_recorded_monotone(self):
        idx, _ = build(smooth(), nlist=64, target_recall=0.9,
                       graph_degree=0)
        co = idx._corpus
        assert co._tune_curve
        ps = [p for p, _ in co._tune_curve]
        rs = [r for _, r in co._tune_curve]
        assert ps == sorted(ps)
        assert all(b >= a - 1e-9 for a, b in zip(rs, rs[1:]))
        assert all(0.0 <= r <= 1.0 for r in rs)
        met = [p for p, r in co._tune_curve if r >= 0.9]
        assert co._nprobe_tuned == (met[0] if met
                                    else co._centroids_h.shape[0])

    def test_index_info_reports_tuned_state(self):
        idx, _ = build(smooth(), nlist=64, target_recall=0.9,
                       graph_degree=0)
        co = idx._corpus
        info = idx.index_info()
        assert info["kind"] == "ivf" and info["trained"]
        assert info["nlist"] == co._centroids_h.shape[0]
        assert info["nprobe_tuned"] == co._nprobe_tuned > 0
        assert info["nprobe"] == co._nprobe_tuned
        assert info["target_recall"] == 0.9
        assert info["tune_curve"] and all(
            len(pair) == 2 for pair in info["tune_curve"])
        assert info["size"] == len(idx)

    def test_untrained_index_info(self):
        idx = TorchIvfIndex(DIM, device="cpu", target_recall=0.9)
        assert idx.index_info() == {"kind": "ivf", "size": 0,
                                    "capacity": 0, "device": "cpu",
                                    "trained": False}


class TestTunerCarriedOver:
    """The snapshot-file cases of tests/test_ivf_tune.py, through the
    reference's state() and load_jax_state."""

    def test_carried_pick_skips_the_tuner(self, monkeypatch):
        _, st = reference_state(smooth(), nlist=64, target_recall=0.95)
        tuned = int(st["ivf_nprobe_tuned"])
        assert tuned > 0
        monkeypatch.setattr(
            IvfCorpus, "_tune_nprobe",
            lambda self, *a, **k: (_ for _ in ()).throw(
                AssertionError("tuner ran on a carried-over pick")))
        port = TorchIvfIndex(DIM, nlist=64, target_recall=0.95,
                             graph_degree=0, device="cpu")
        port._corpus.load_jax_state(st)
        port._corpus.sync()
        assert port._corpus._nprobe_tuned == tuned

    def test_carried_curve_boost_and_delivered(self):
        ref, st = reference_state(smooth(), nlist=64, target_recall=0.9)
        st["ivf_cand_boost"] = np.int32(2)       # as if escalation fired
        st["ivf_delivered"] = np.float64(0.991)
        port = TorchIvfIndex(DIM, nlist=64, target_recall=0.9,
                             graph_degree=0, device="cpu")
        port._corpus.load_jax_state(st)
        port._corpus.sync()
        co = port._corpus
        curve = [(int(p), float(r)) for p, r in st["ivf_tune_curve"]]
        assert co._tune_curve == curve == ref._corpus._tune_curve
        assert co._cand_boost == 2
        info = port.index_info()
        assert info["delivered_recall"] == 0.991
        assert info["tune_curve"] == [[p, round(r, 4)] for p, r in curve]
        assert info["nprobe_tuned"] == int(st["ivf_nprobe_tuned"])

    def test_explicit_nprobe_ignores_a_carried_pick(self):
        _, st = reference_state(smooth(), nlist=64, target_recall=0.95)
        port = TorchIvfIndex(DIM, nlist=64, nprobe=5, target_recall=0.95,
                             graph_degree=0, device="cpu")
        port._corpus.load_jax_state(st)
        port._corpus.sync()
        co = port._corpus
        assert co._nprobe_tuned == 0
        assert co._nprobe(co._centroids_h.shape[0]) == 5

    def test_trivial_layout_clears_stale_curve(self):
        idx, _ = build(smooth(), nlist=64, target_recall=0.9,
                       graph_degree=0)
        co = idx._corpus
        assert co._nprobe_tuned > 0 and co._tune_curve
        for i in range(30, 800):
            idx.remove(f"n{i:04d}")
        idx.retrain()
        assert co._nprobe_tuned == 0
        assert co._tune_curve == []

    def test_retrain_remeasures(self):
        vecs = smooth()
        idx, _ = build(vecs, nlist=64, target_recall=0.95, graph_degree=0)
        first = idx._corpus._nprobe_tuned
        assert first > 0
        idx.insert_batch([f"b{i:04d}" for i in range(800)], blocky())
        for i in range(len(vecs)):
            idx.remove(f"n{i:04d}")
        idx.retrain()
        co = idx._corpus
        c = co._centroids_h.shape[0]
        assert 0 < co._nprobe_tuned <= max(8, c // 8) < first


class TestConfig:
    def test_validation_bounds(self):
        from cortex_tpu_torch.config import CortexConfig
        from cortex_tpu_torch.errors import ConfigError
        cfg = CortexConfig.from_dict(
            {"embedding": {"index": "ivf", "ivf_target_recall": 1.5}})
        with pytest.raises(ConfigError):
            cfg.validate()
        ok = CortexConfig.from_dict(
            {"embedding": {"index": "ivf", "ivf_target_recall": 0.9}})
        ok.validate()
        assert ok.embedding.ivf_target_recall == 0.9

    def test_target_flows_from_config_and_tunes(self):
        from cortex_tpu_torch import Cortex
        from cortex_tpu_torch.config import CortexConfig
        from cortex_tpu_torch.types import Node, Source
        cfg = CortexConfig()
        cfg.embedding.index = "ivf"
        cfg.embedding.ivf_target_recall = 0.95
        cfg.embedding.ivf_nlist = 16
        cx = Cortex.in_memory(cfg, device="cpu")
        try:
            cx.store_batch([Node.new("fact", f"tuned note {i} t{i % 9}",
                                     f"body {i % 13}", Source(agent="a"))
                            for i in range(400)])
            assert cx.search("tuned note 5 t5", 5, record_access=False)
            co = cx.index._corpus
            assert co._target_recall == 0.95 and co._graph_degree == 32
            assert co._nprobe_tuned > 0 and co._tune_curve
        finally:
            cx.close()


class TestInfoSnapshot:
    def test_index_info_lock_free_during_retrains(self):
        """index_info reads one published dict: every read is whole and
        fast while the corpus flips between geometries and retrains."""
        idx, _ = build(smooth(), nlist=64, target_recall=0.9,
                       graph_degree=0)
        stop = _t.monotonic() + 3.0
        errs = []

        def reader():
            while _t.monotonic() < stop:
                info = idx.index_info()
                try:
                    assert info["kind"] == "ivf"
                    if info["trained"]:
                        assert info["nlist"] >= 1
                        assert 1 <= info["nprobe"] <= info["nlist"]
                        if info["nprobe_tuned"] == 0:
                            assert info["tune_curve"] == []
                    else:
                        assert "nlist" not in info
                except AssertionError as e:
                    errs.append(repr(e))
                    return

        t = threading.Thread(target=reader)
        t.start()
        ids2 = [f"x{i:04d}" for i in range(800)]
        flip = 0
        while _t.monotonic() < stop:
            if flip % 2 == 0:
                idx.insert_batch(ids2, blocky())
                for i in range(800):
                    idx.remove(f"n{i:04d}" if flip == 0 else f"x{i:04d}")
            else:
                idx.insert_batch([f"n{i:04d}" for i in range(800)],
                                 smooth())
            idx.retrain()
            flip += 1
        t.join()
        assert errs == []
        t0 = _t.monotonic()
        idx.index_info()
        assert _t.monotonic() - t0 < 0.1


class TestDeliveredRecallGate:
    def test_delivered_measured_and_published(self):
        idx, _ = build(smooth(), target_recall=0.9)
        info = idx.index_info()
        assert info["nprobe_tuned"] > 0
        assert info["delivered_recall"] is not None
        assert 0.7 <= info["delivered_recall"] <= 1.0
        assert info["cand_boost"] >= 1

    @pytest.mark.parametrize("readings,boost,delivered,calls", [
        ({1: 0.95, 2: 0.985, 4: 0.995}, 4, 0.995, [1, 2, 4]),
        ({1: 0.973, 2: 0.973, 4: 0.973}, 1, 0.973, [1, 2]),
    ], ids=["escalates", "reverts"])
    def test_candidate_width_escalation(self, monkeypatch, readings, boost,
                                        delivered, calls):
        """The tuner widens the candidate list while the delivered
        recall misses the target and widening helps, and refunds a rung
        that did not help (tests/test_ivf_tune.py's two loop cases, on
        the real _tune_nprobe)."""
        idx, _ = build(smooth(), nlist=64, target_recall=0.9,
                       graph_degree=0)
        co = idx._corpus
        seen = []

        def fake_measure(q, qrows, truth, valid):
            seen.append(co._cand_boost)
            return readings[co._cand_boost]

        monkeypatch.setattr(co, "_measure_delivered", fake_measure)
        co._target_recall = 0.99
        idx.retrain()
        assert seen == calls
        assert co._cand_boost == boost
        assert co._delivered_recall == delivered
        assert idx.index_info()["cand_boost"] == boost

    def test_boost_widens_the_dispatched_candidates(self):
        idx, _ = build(smooth(), nlist=64, target_recall=0.9,
                       graph_degree=0)
        co = idx._corpus
        q = smooth(4, seed=5)
        flt = co._search_filter()
        widths = []
        for boost in (1, 2, 4):
            co._cand_boost = boost
            v, _, _ = co._dispatch_search(q, flt, 16)
            widths.append(v.shape[1])
        assert widths[0] < widths[1] < widths[2]


# ---------------------------------------------------------- parity


def test_chunk_truth_equals_reference_tune_chunk_topk(tmp_path):
    """K1 over a chunk of the flattened layout with the dead-slot bias is
    the reference's _tune_chunk_topk: values within 1e-6 relative (XLA's
    per-query scale 127 / max|q| can differ from the IEEE quotient in its
    last bit), and every row scored more than 1e-6 above the k-th value
    in one list is in the other (a spilled row's two copies tie exactly,
    and ties at the k-th value may keep other rows)."""
    _, st = reference_state(smooth(), nlist=64)
    _, port = loaded_pair(tmp_path, st, nlist=64)
    _, emb, rinv, rows, _, _ = port._corpus._ivf_dev
    q = smooth(40, seed=4)
    qi8, qs = quantize_queries(torch.from_numpy(q))
    for c0, cc in ((0, 16), (48, 16), (0, emb.shape[0])):
        sr = rows[c0:c0 + cc].reshape(-1)
        bias = torch.where(sr >= 0, 0.0, NEG_INF).to(torch.float32)
        v, i = quant_candidates(emb[c0:c0 + cc].reshape(-1, DIM),
                                rinv[c0:c0 + cc].reshape(-1), qi8, qs,
                                bias, 32)
        wv, wr = _tune_chunk_topk(jnp.asarray(emb[c0:c0 + cc].numpy()),
                                  jnp.asarray(rinv[c0:c0 + cc].numpy()),
                                  jnp.asarray(rows[c0:c0 + cc].numpy()),
                                  jnp.asarray(q), k=32)
        v, wv, wr = v.numpy(), np.asarray(wv), np.asarray(wr)
        np.testing.assert_allclose(v, wv, rtol=1e-6, atol=0)
        got_rows = sr[i.long()].numpy()
        for b in range(len(v)):
            for mine, other, vals in ((got_rows, wr, v), (wr, got_rows, wv)):
                above = vals[b] > vals[b, -1] + 1e-6
                assert set(mine[b][above]) <= set(other[b])


@pytest.mark.parametrize("target", [0.8, 0.95])
def test_pick_and_curve_equal_reference_from_same_state(tmp_path, target):
    """Tuner keys dropped from the state: both packages tune the same
    loaded layout and pick the same rung from the same curve."""
    _, st = reference_state(smooth(), nlist=64)
    for key in TUNER_KEYS:
        st.pop(key, None)
    ref, port = loaded_pair(tmp_path, st, nlist=64, target_recall=target)
    rco, co = ref._corpus, port._corpus
    assert rco._nprobe_tuned > 0
    assert co._nprobe_tuned == rco._nprobe_tuned
    assert co._tune_curve == rco._tune_curve
    assert co._cand_boost == rco._cand_boost
    assert co._delivered_recall == pytest.approx(rco._delivered_recall,
                                                 abs=1e-12)
    info, rinfo = port.index_info(), ref.index_info()
    for key in ("nlist", "nprobe", "nprobe_tuned", "tune_curve",
                "delivered_recall", "cand_boost", "target_recall"):
        assert info[key] == rinfo[key], key


# ------------------------------------------- the named deviation


def delivered_inputs(co, s=32):
    """A tuner-like sample of s rows with their exact top-10 (self
    excluded) from the host mirror."""
    rows = np.where(co._live_h)[0]
    pick = rows[np.random.default_rng(1).choice(len(rows), s, replace=False)]
    q = co._emb_h[pick].copy()
    sc = q @ co._emb_h[rows].T
    sc[np.arange(s), np.searchsorted(rows, pick)] = -np.inf
    truth = rows[np.argsort(-sc, axis=1, kind="stable")[:, :TUNE_TRUTH_K]]
    return q, pick, truth.astype(np.int64), np.ones_like(truth, bool)


def test_empty_candidate_lists_count_as_misses(monkeypatch):
    """Regression (ROADMAP queue C): a sampled query with no candidate
    counts its truth rows as misses, so a sample whose every list is
    empty measures 0.0, not None, and half-empty lists halve the
    reading."""
    idx, _ = build(smooth(), nlist=64, graph_degree=0)
    co = idx._corpus
    q, qrows, truth, valid = delivered_inputs(co)
    full = co._measure_delivered(q, qrows, truth, valid)
    assert full is not None and full > 0.5
    orig = co._dispatch_search

    def half_empty(*a, **k):
        v, rows, rescore = orig(*a, **k)
        v, rows = v.clone(), rows.clone()
        v[::2] = NEG_INF
        rows[::2] = -1
        return v, rows, rescore

    monkeypatch.setattr(co, "_dispatch_search", half_empty)
    half = co._measure_delivered(q, qrows, truth, valid)
    monkeypatch.setattr(co, "_dispatch_search", lambda *a, **k: (
        torch.full((len(q), 64), NEG_INF), torch.zeros((len(q), 64),
                                                        dtype=torch.int32),
        True))
    assert co._measure_delivered(q, qrows, truth, valid) == 0.0
    # the odd queries' hits over every query's truth rows
    monkeypatch.setattr(co, "_dispatch_search", orig)
    odd = co._measure_delivered(q[1::2], qrows[1::2], truth[1::2],
                                valid[1::2])
    assert half == pytest.approx(odd / 2)


def test_delivered_deviation_from_reference(tmp_path, monkeypatch):
    """Parity, naming the deviation: on the same layout and sample, with
    every other query's list emptied, the reference skips those queries
    (H / T_kept) and the port counts them as misses (H / T_all); the
    hits H are the same. With no list empty the two agree."""
    _, st = reference_state(smooth(), nlist=64)
    ref, port = loaded_pair(tmp_path, st, nlist=64, nprobe=8)
    rco, co = ref._corpus, port._corpus
    q, qrows, truth, valid = delivered_inputs(co)
    assert [co._id_of[r] for r in qrows] == [rco._id_of[r] for r in qrows]
    same_ref = rco._measure_delivered(q, qrows, truth, valid)
    same_port = co._measure_delivered(q, qrows, truth, valid)
    assert same_port == pytest.approx(same_ref, abs=1e-12)

    r_orig, p_orig = rco._dispatch_search, co._dispatch_search

    def ref_half(*a, **k):
        v, rows, rescore = r_orig(*a, **k)
        return (v.at[::2].set(NEG_INF), rows.at[::2].set(-1), rescore)

    def port_half(*a, **k):
        v, rows, rescore = p_orig(*a, **k)
        v, rows = v.clone(), rows.clone()
        v[::2] = NEG_INF
        rows[::2] = -1
        return v, rows, rescore

    monkeypatch.setattr(rco, "_dispatch_search", ref_half)
    monkeypatch.setattr(co, "_dispatch_search", port_half)
    got_ref = rco._measure_delivered(q, qrows, truth, valid)
    got_port = co._measure_delivered(q, qrows, truth, valid)
    kept = int(valid[1::2].sum())
    total = int(valid.sum())
    assert got_port == pytest.approx(got_ref * kept / total, abs=1e-12)
    assert got_port < got_ref
