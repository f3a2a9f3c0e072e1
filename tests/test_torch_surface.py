"""The reference's public names that came to the port last, held to the
reference on the CPU with the same inputs (made from a seed with numpy):

  * vector.BruteForceIndex: equal ids and scores to 1e-6 and the same
    tie order (duplicated rows tie exactly), with filters, after
    removes, and across each other's save files;
  * native.dijkstra_maxprod: the same path and weight;
  * native.decay_sweep_native: weights bit-equal, flags equal;
  * ops.cosine_topk (exact, and prefer_approx) and ops.cosine_topk_quant:
    the reference's ops at their shapes (scores to 1e-5; ids equal where
    no two scores of a row are within 1e-6);
  * ops.decay.decay_sweep: the scalars by position equal them by name;
  * utils.profile_trace: a Chrome trace in log_dir, and a warning, not an
    error, when a profiler already runs;
  * entry.entry(): the port's step(*args) against the reference's
    jitted(*args) from __graft_entry__.py: equal top-16 ids where no two
    scores of a row are within 1e-6, scores to 1e-5.
"""

import json
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ref_entry
from cortex_tpu import native as ref_native
from cortex_tpu.ops import similarity as ref_sim
from cortex_tpu.vector import BruteForceIndex as RefBruteForce
from cortex_tpu.vector import VectorFilter as RefFilter
from cortex_tpu_torch import native
from cortex_tpu_torch.entry import entry
from cortex_tpu_torch.ops import cosine_topk, cosine_topk_quant
from cortex_tpu_torch.ops.decay import decay_sweep
from cortex_tpu_torch.ops.similarity import normalize_rows, quantize_rows
from cortex_tpu_torch.utils import profile_trace
from cortex_tpu_torch.vector import BruteForceIndex, VectorFilter

SCORE_ATOL = 1e-6      # BruteForceIndex: one numpy product both sides
OPS_ATOL = 1e-5        # torch vs XLA products on the CPU
NEAR_TIE = 1e-6


def tie_free_columns(scores: np.ndarray) -> np.ndarray:
    """[B, K] bool: True where a sorted row's score is more than
    NEAR_TIE from both neighbours, so its rank is decided."""
    gap = np.abs(np.diff(scores, axis=1)) > NEAR_TIE
    pad = np.ones((scores.shape[0], 1), bool)
    return np.concatenate([pad, gap], 1) & np.concatenate([gap, pad], 1)


def corpus(n=300, d=24, seed=0):
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    t = min(40, n // 2)
    vecs[n // 2:n // 2 + t] = vecs[:t]            # exact ties
    kinds = [("fact", "event", "decision")[i % 3] for i in range(n)]
    agents = [("a", "b")[i % 2] for i in range(n)]
    return vecs, kinds, agents


def filled(cls, vecs, kinds, agents):
    idx = cls(vecs.shape[1])
    for i, v in enumerate(vecs):
        idx.insert(f"n{i}", v, kind=kinds[i], source_agent=agents[i])
    return idx


def same_hits(got, want):
    for g, w in zip(got, want, strict=True):
        assert [i for i, _ in g] == [i for i, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w],
                                   atol=SCORE_ATOL)


@pytest.mark.parametrize("flt", [
    None, dict(kinds=["event"]), dict(source_agent="b"),
    dict(kinds=["fact", "decision"], source_agent="a",
         exclude_ids=[f"n{i}" for i in range(0, 300, 7)]),
])
def test_bruteforce_matches_reference(flt):
    vecs, kinds, agents = corpus()
    ours = filled(BruteForceIndex, vecs, kinds, agents)
    ref = filled(RefBruteForce, vecs, kinds, agents)
    for i in range(0, 300, 11):
        assert ours.remove(f"n{i}") == ref.remove(f"n{i}")
    assert len(ours) == len(ref) and ("n11" in ours) == ("n11" in ref)
    q = np.concatenate([vecs[:8], np.random.default_rng(1).normal(
        size=(8, vecs.shape[1])).astype(np.float32)])
    got = ours.search_batch(q, 12, VectorFilter(**flt) if flt else None)
    want = ref.search_batch(q, 12, RefFilter(**flt) if flt else None)
    same_hits(got, want)
    assert any(g[0][1] == g[1][1] for g in got[:8] if len(g) > 1)


def test_bruteforce_files_open_in_either_package(tmp_path):
    vecs, kinds, agents = corpus(n=60)
    ours = filled(BruteForceIndex, vecs, kinds, agents)
    ref = filled(RefBruteForce, vecs, kinds, agents)
    ours.save(str(tmp_path / "port.npz"))
    ref.save(str(tmp_path / "ref.npz"))
    ours_back, ref_back = BruteForceIndex(24), RefBruteForce(24)
    ours_back.load(str(tmp_path / "ref.npz"))
    ref_back.load(str(tmp_path / "port.npz"))
    q = vecs[:5]
    same_hits(ours_back.search_batch(q, 9, VectorFilter(kinds=["fact"])),
              ref_back.search_batch(q, 9, RefFilter(kinds=["fact"])))
    assert BruteForceIndex(24).search_batch(q, 3) == [[]] * 5


def random_csr(n, m, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    order = np.argsort(src, kind="stable")
    indptr = np.zeros(n + 1, np.int32)
    np.add.at(indptr, src + 1, 1)
    return (np.cumsum(indptr).astype(np.int32), dst[order].astype(np.int32),
            rng.uniform(0.05, 1.0, m).astype(np.float32))


@pytest.mark.parametrize("seed", range(4))
def test_dijkstra_matches_reference(seed):
    indptr, indices, weights = random_csr(200, 700, seed)
    rng = np.random.default_rng(100 + seed)
    reached = 0
    for src, dst in rng.integers(0, 200, (40, 2)):
        for max_len in (0, 3):
            got = native.dijkstra_maxprod(indptr, indices, weights,
                                          int(src), int(dst),
                                          max_len=max_len)
            want = ref_native.dijkstra_maxprod(indptr, indices, weights,
                                               int(src), int(dst),
                                               max_len=max_len)
            assert got[0].tolist() == want[0].tolist()
            assert got[1] == want[1]
            reached += len(got[0]) > 0
    assert reached > 10
    assert native.dijkstra_maxprod(indptr, indices, weights, 0, 999)[0].size == 0


def test_decay_sweep_native_matches_reference():
    rng = np.random.default_rng(7)
    n = 10_007
    w = rng.uniform(0, 1, n).astype(np.float32)
    rates = rng.uniform(0, 0.1, n).astype(np.float32)
    days = rng.uniform(0, 90, n).astype(np.float32)
    got_w, got_f = native.decay_sweep_native(w.copy(), rates, days,
                                             0.05, 0.2)
    want_w, want_f = ref_native.decay_sweep_native(w.copy(), rates, days,
                                                   0.05, 0.2)
    assert got_w.tobytes() == want_w.tobytes()
    assert (got_f == want_f).all() and set(np.unique(got_f)) == {0, 1, 2}


def test_decay_sweep_takes_the_scalars_by_position():
    rng = np.random.default_rng(3)
    n = 257
    t = [torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32)),
         torch.from_numpy(rng.uniform(0, 400, n).astype(np.float32)),
         torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32)),
         torch.from_numpy(rng.random(n) < 0.3)]
    pos = decay_sweep(*t, 0.01, 0.8, 0.05, 0.1)
    kw = decay_sweep(*t, daily_rate=0.01, shield=0.8,
                     delete_threshold=0.05, prune_threshold=0.1)
    for a, b in zip(pos, kw, strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("k,prefer_approx", [(10, None), (10, True),
                                             (700, None)])
def test_cosine_topk_matches_reference(k, prefer_approx):
    rng = np.random.default_rng(5)
    emb = normalize_rows(rng.normal(size=(600, 32)).astype(np.float32))
    q = normalize_rows(rng.normal(size=(9, 32)).astype(np.float32))
    bias = np.where(rng.random(600) < 0.2, -1e30, 0).astype(np.float32)
    got_v, got_i = cosine_topk(torch.from_numpy(emb), torch.from_numpy(q),
                               k, torch.from_numpy(bias),
                               prefer_approx=prefer_approx)
    want_v, want_i = ref_sim.cosine_topk(jnp.asarray(emb), jnp.asarray(q),
                                         k, jnp.asarray(bias),
                                         prefer_approx=prefer_approx)
    assert got_v.shape == want_v.shape == (9, k)
    np.testing.assert_allclose(got_v, want_v, atol=OPS_ATOL, rtol=0)
    live = want_v > -1e29
    decided = tie_free_columns(want_v) & live
    assert (got_i[decided] == want_i[decided]).all()


def test_cosine_topk_quant_matches_reference():
    rng = np.random.default_rng(6)
    emb = normalize_rows(rng.normal(size=(500, 32)).astype(np.float32))
    q = normalize_rows(rng.normal(size=(5, 32)).astype(np.float32))
    e8, rinv = quantize_rows(emb)
    got_v, got_i = cosine_topk_quant(torch.from_numpy(e8),
                                     torch.from_numpy(rinv),
                                     torch.from_numpy(q), 40)
    want_v, want_i = ref_sim.cosine_topk_quant(
        jnp.asarray(e8), jnp.asarray(rinv), jnp.asarray(q), 40)
    want_v, want_i = np.asarray(want_v), np.asarray(want_i)
    np.testing.assert_allclose(got_v.numpy(), want_v, atol=OPS_ATOL, rtol=0)
    decided = tie_free_columns(want_v)
    assert (got_i.numpy()[decided] == want_i[decided]).all()


def test_profile_trace_writes_a_chrome_trace(tmp_path, caplog):
    with profile_trace(str(tmp_path / "prof")):
        with caplog.at_level(logging.WARNING, logger="cortex.trace"):
            with profile_trace(str(tmp_path / "nested")):
                torch.ones(64).sum()
    files = os.listdir(tmp_path / "prof")
    assert len(files) == 1 and files[0].endswith(".json")
    trace = json.loads((tmp_path / "prof" / files[0]).read_text())
    assert trace["traceEvents"]
    assert not (tmp_path / "nested").exists()
    assert "profiler unavailable" in caplog.text


def test_entry_matches_reference():
    step, args = entry("cpu")
    assert [tuple(a.shape) for a in args[:2]] == [(8192, 384), (32, 384)]
    got_v, got_i = (t.numpy() for t in step(*args))
    jitted, jargs = ref_entry.entry()
    want_v, want_i = (np.asarray(t) for t in jitted(*jargs))
    assert got_v.shape == want_v.shape == (32, 16)
    np.testing.assert_allclose(got_v, want_v, atol=OPS_ATOL, rtol=0)
    decided = tie_free_columns(want_v)
    assert decided.mean() > 0.9
    assert (got_i[decided] == want_i[decided]).all()


def test_chip_smoke_phase_15_rehearses_on_the_cpu(capsys):
    import chip_smoke
    chip_smoke.phase_reference_cases(torch.device("cpu"), "cpu")
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    cases, ent = lines
    assert cases["phase"] == "15-reference-cases"
    assert [f["checks"] for f in cases["model_fuzz"]] == [9, 9, 9]
    assert all(f["searches"] > 20 for f in cases["ivf_fuzz"])
    assert [t["exact_ties"] > 0 for t in cases["tie_order"]] == [True] * 2
    assert ent["phase"] == "15-entry" and ent["shape"] == [32, 16]
