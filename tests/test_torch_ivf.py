"""The port's IVF index (cortex_tpu_torch/vector/ivf.py) against the JAX
package's, on the CPU.

The JAX index runs its Pallas search path (the kernel in interpret
mode). Layouts are carried across with IvfCorpus.load_jax_state, so both
packages hold the same [C, L, d] layout slot for slot and partial-probe
results do not depend on k-means float differences. Tolerances: ids
equal, scores within 1e-5 (the final scores are the same fp32 host
re-rank in both packages).
"""

import numpy as np
import pytest

from cortex_tpu.ops import ivf_gather as jax_gather
from cortex_tpu.vector import BruteForceIndex, TpuIvfIndex, VectorFilter
from cortex_tpu.vector.ivf import (IvfCorpus, _ivf_search_pallas,
                                   _ivf_search_pallas_hostbias)
from cortex_tpu_torch.vector import TorchIvfIndex
from cortex_tpu_torch.vector import VectorFilter as TorchVectorFilter

DIM = 32
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setattr(jax_gather, "INTERPRET", True)
    monkeypatch.setattr(IvfCorpus, "_use_pallas", lambda self, cap: True)
    yield
    jax_gather.probed_scores.clear_cache()
    _ivf_search_pallas.clear_cache()
    _ivf_search_pallas_hostbias.clear_cache()


def clustered(n, dim=DIM, *, groups=None, seed=0):
    """Clustered corpus (~8 members per center): the structure IVF
    exploits."""
    rng = np.random.default_rng(seed)
    g = groups or max(1, n // 8)
    centers = rng.standard_normal((g, dim)).astype(np.float32)
    return (np.repeat(centers, (n + g - 1) // g, axis=0)[:n]
            + 0.25 * rng.standard_normal((n, dim)).astype(np.float32))


def meta_of(n):
    kinds = [("fact", "event", "goal")[i % 3] for i in range(n)]
    agents = [("a", "b")[i % 2] for i in range(n)]
    return kinds, agents


def carried_pair(tmp_path, n=240, nlist=8, nprobe=3):
    """(JAX index loaded from a snapshot of a trained JAX index, port
    index loaded from the same state) — the same layout in both."""
    vecs = clustered(n)
    kinds, agents = meta_of(n)
    ids = [f"n{i}" for i in range(n)]
    trained = TpuIvfIndex(DIM, nlist=nlist, nprobe=nprobe, graph_degree=0)
    trained.insert_batch(ids, vecs, kinds=kinds, agents=agents)
    trained._corpus.sync()
    st = trained._corpus.state()
    path = str(tmp_path / "ivf.npz")
    trained.write_snapshot(path, st)
    ref = TpuIvfIndex(DIM, nlist=nlist, nprobe=nprobe, graph_degree=0)
    ref.load(path)
    port = TorchIvfIndex(DIM, nlist=nlist, nprobe=nprobe, device="cpu")
    port._corpus.load_jax_state(st)
    ref._corpus.sync()
    port._corpus.sync()
    return ref, port, vecs


def assert_planes_equal(ref, port):
    cent, emb, rinv, rows, kind, agent, _meta = ref._corpus._ivf_dev
    got = [t.numpy() for t in port._corpus._ivf_dev]
    for want, have in zip((cent, emb, rinv, rows, kind, agent), got):
        np.testing.assert_array_equal(have, np.asarray(want))


def assert_same_hits(want, got, atol=ATOL):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert [i for i, _ in g] == [i for i, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w],
                                   atol=atol)


def both(flt_kwargs):
    return VectorFilter(**flt_kwargs), TorchVectorFilter(**flt_kwargs)


def test_load_jax_state_gives_the_same_planes(tmp_path):
    ref, port, _ = carried_pair(tmp_path)
    assert port._corpus._has_spill and ref._corpus._has_spill
    assert port._corpus._slot_cap == ref._corpus._slot_cap
    assert_planes_equal(ref, port)
    np.testing.assert_array_equal(port._corpus._quant_mu,
                                  ref._corpus._quant_mu)


FILTERS = {
    "none": {},
    "kinds": {"kinds": ["fact", "goal"]},
    "agent": {"source_agent": "b"},
    "exclude": {"exclude_ids": [f"n{i}" for i in range(0, 240, 7)]},
    "exclude_overflow": {"exclude_ids": [f"n{i}" for i in range(80)]},
    "kinds_overflow": {"kinds": [f"k{i}" for i in range(17)] + ["event"]},
}


@pytest.mark.parametrize("nprobe", [3, 8], ids=["partial", "full"])
@pytest.mark.parametrize("flt", list(FILTERS))
def test_search_parity(tmp_path, nprobe, flt):
    ref, port, _ = carried_pair(tmp_path, nprobe=nprobe)
    q = clustered(6, seed=3)
    f_ref, f_port = both(FILTERS[flt])
    assert_same_hits(ref.search_batch(q, 10, f_ref),
                     port.search_batch(q, 10, f_port))


def test_updates_after_build_and_slot_growth(tmp_path):
    """Inserts, updates and removes after the build go through
    _apply_dirty in both packages; enough inserts exhaust the free slots
    and grow the slot axis in place."""
    ref, port, _ = carried_pair(tmp_path, nprobe=3)
    l0 = port._corpus._slot_cap
    extra = clustered(90, seed=11)
    ids = [f"x{i}" for i in range(len(extra))]
    kinds = ["fact"] * len(extra)
    agents = ["c"] * len(extra)
    for idx in (ref, port):
        idx.insert_batch(ids, extra, kinds=kinds, agents=agents)
        idx.insert("n3", extra[0] * -1.0, kind="goal", source_agent="a")
        assert idx.remove("n5")
        assert idx.remove("x7")
    q = np.concatenate([extra[:4], clustered(3, seed=5)])
    want = ref.search_batch(q, 10)
    got = port.search_batch(q, 10)
    assert port._corpus._slot_cap > l0
    assert port._corpus._slot_cap == ref._corpus._slot_cap
    assert_planes_equal(ref, port)
    assert_same_hits(want, got)
    found = {i for hits in got for i, _ in hits}
    assert "n5" not in found and "x7" not in found
    assert got[1][0][0] == "x1"               # a fresh row finds itself


def test_spill_dedup_returns_each_id_once(tmp_path):
    ref, port, vecs = carried_pair(tmp_path, nprobe=4)
    co = port._corpus
    spilled = np.where(co._cluster_of2 >= 0)[0]
    assert len(spilled) > 0
    # query with spilled rows themselves: both copies can be probed
    rows = spilled[:8]
    q = co._emb_h[rows]
    for hits in port.search_batch(q, 40):
        ids = [i for i, _ in hits]
        assert len(ids) == len(set(ids))
    assert_same_hits(ref.search_batch(q, 40), port.search_batch(q, 40))


@pytest.mark.parametrize("seed", [0, 1])
def test_full_probe_matches_jax_and_brute_force(seed):
    """Each package trains its own clustering here; at nprobe = nlist
    the candidates cover every row, so both reproduce the exact scan."""
    vecs = clustered(300, seed=seed)
    kinds, agents = meta_of(len(vecs))
    ids = [f"n{i}" for i in range(len(vecs))]
    ref = TpuIvfIndex(DIM, nlist=8, nprobe=8, graph_degree=0)
    port = TorchIvfIndex(DIM, nlist=8, nprobe=8, device="cpu")
    oracle = BruteForceIndex(DIM)
    for idx in (ref, port):
        idx.insert_batch(ids, vecs, kinds=kinds, agents=agents)
    for i, nid in enumerate(ids):
        oracle.insert(nid, vecs[i], kind=kinds[i], source_agent=agents[i])
    q = clustered(5, seed=seed + 7)
    got = port.search_batch(q, 10)
    assert_same_hits(oracle.search_batch(q, 10), got)
    assert_same_hits(ref.search_batch(q, 10), got)
    f_ref, f_port = both({"kinds": ["event"]})
    assert_same_hits(oracle.search_batch(q, 10, f_ref),
                     port.search_batch(q, 10, f_port))


def test_empty_and_tiny_corpus():
    port = TorchIvfIndex(DIM, device="cpu")
    assert port.search_batch(clustered(2, seed=1), 5) == [[], []]
    port.insert("only", clustered(1)[0], kind="fact")
    hits = port.search(clustered(1)[0], 5)
    assert [i for i, _ in hits] == ["only"]
    assert abs(hits[0][1] - 1.0) < 1e-5
    assert port.remove("only") and not port.remove("only")
    assert port.search(clustered(1)[0], 5) == []


def test_concurrent_writers_and_searchers():
    """Writers (insert, overwrite, remove) and searchers share one
    corpus: searches fetch outside the corpus lock and re-issue when a
    row was reassigned meanwhile. Invariants: nothing raises, only ids
    that were ever written come back, and once the threads stop the
    index answers exactly like the brute-force oracle."""
    import sys
    import threading

    port = TorchIvfIndex(DIM, nlist=4, nprobe=4, device="cpu")
    base = clustered(120, seed=21)
    port.insert_batch([f"b{i}" for i in range(len(base))], base)
    universe = {f"b{i}" for i in range(len(base))}
    universe |= {f"w{t}_{i}" for t in range(3) for i in range(40)}
    errors, stop = [], threading.Event()

    def writer(t):
        rng = np.random.default_rng(t)
        try:
            while not stop.is_set():
                i = int(rng.integers(0, 40))
                nid = f"w{t}_{i}"
                if rng.random() < 0.4:
                    port.remove(nid)
                else:
                    port.insert(nid, rng.standard_normal(DIM), kind="fact")
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    def searcher(t):
        rng = np.random.default_rng(100 + t)
        try:
            while not stop.is_set():
                for hits in port.search_batch(
                        rng.standard_normal((3, DIM)), 8):
                    assert {i for i, _ in hits} <= universe
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=writer, args=(t,))
                   for t in range(3)]
        threads += [threading.Thread(target=searcher, args=(t,))
                    for t in range(5)]
        for th in threads:
            th.start()
        stop.wait(2.0)
        stop.set()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors[:3]
    co = port._corpus
    oracle = BruteForceIndex(DIM)
    for nid, r in co._row_of.items():
        oracle.insert(nid, co._emb_h[r])
    q = clustered(4, seed=22)
    assert_same_hits(oracle.search_batch(q, 10), port.search_batch(q, 10))
