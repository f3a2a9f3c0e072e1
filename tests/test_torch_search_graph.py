"""The IVF search's captured-graph rule (cortex_tpu_torch/vector/ivf.py::
graph_key, IvfCorpus._set_layout), on the CPU.

graph_key decides which dispatches replay a captured CUDA graph: a CUDA
device, 1..GRAPH_MAX_BATCH queries, no overflowing filter; any part of
the key that changes (the layout's generation among them) names a new
graph. A CPU index never captures: its counters stay at 0 and its
answers are the exact top k at a full probe. The layout's generation
bumps wherever a new layout is assigned, and not for the in-place slot
writes a replay sees. The graphs themselves run on the card
(tests/test_torch_search_graph_cuda.py).
"""

import numpy as np
import pytest

from cortex_tpu_torch.ops.similarity import normalize_rows
from cortex_tpu_torch.utils import tracing
from cortex_tpu_torch.vector import ivf
from cortex_tpu_torch.vector.ivf import TorchIvfIndex, graph_key

DIM = 32
KEY = dict(filtered=False, dedup=True, p=8, cand=64, generation=3)


def clustered(n, dim=DIM, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((max(1, n // 8), dim)).astype(np.float32)
    return (np.repeat(centers, 8, axis=0)[:n]
            + 0.25 * rng.standard_normal((n, dim)).astype(np.float32))


def built(n=400, nlist=8, nprobe=8, spill=1.0):
    vecs = clustered(n)
    index = TorchIvfIndex(DIM, nlist=nlist, nprobe=nprobe, spill=spill,
                          graph_degree=0, device="cpu")
    ids = [f"n{i}" for i in range(n)]
    kinds = [("fact", "event", "goal")[i % 3] for i in range(n)]
    agents = [("a", "b")[i % 2] for i in range(n)]
    index.insert_batch(ids, vecs, kinds=kinds, agents=agents)
    index._corpus.sync()
    return index, vecs, ids, kinds, agents


@pytest.mark.parametrize("b", [1, 3, ivf.GRAPH_MAX_BATCH])
def test_small_cuda_batches_get_a_key(b):
    key = graph_key("cuda", b, False, **KEY)
    assert key is not None and key[0] == b


@pytest.mark.parametrize("b", [0, ivf.GRAPH_MAX_BATCH + 1, 64, 512])
def test_empty_and_large_batches_run_eagerly(b):
    assert graph_key("cuda", b, False, **KEY) is None


def test_an_overflowing_filter_runs_eagerly():
    assert graph_key("cuda", 1, True, **KEY) is None


@pytest.mark.parametrize("device_type", ["cpu", "meta"])
def test_no_graph_off_cuda(device_type):
    assert graph_key(device_type, 1, False, **KEY) is None


@pytest.mark.parametrize("change", [
    dict(generation=4), dict(filtered=True), dict(dedup=False), dict(p=16),
    dict(cand=128), dict(tf32=True)])
def test_each_part_of_the_key_names_its_own_graph(change):
    assert (graph_key("cuda", 1, False, **{**KEY, **change})
            != graph_key("cuda", 1, False, **KEY))


def test_the_batch_names_its_own_graph():
    assert graph_key("cuda", 2, False, **KEY) != graph_key("cuda", 1, False,
                                                           **KEY)


@pytest.mark.parametrize("flt", [
    {}, {"kinds": ["fact"]}, {"agent": "a"}, {"exclude_ids": ["n3", "n5"]},
    {"kinds": ["event", "goal"], "agent": "b", "exclude_ids": ["n1"]},
    {"exclude_ids": [f"n{i}" for i in range(65)]}])
@pytest.mark.parametrize("b", [1, 4, ivf.GRAPH_MAX_BATCH + 1])
def test_a_cpu_index_never_captures_and_answers_exactly(b, flt):
    index, vecs, ids, kinds, agents = built()
    co = index._corpus
    rng = np.random.default_rng(b)
    q = vecs[rng.choice(len(vecs), b)] + 0.1 * rng.standard_normal(
        (b, DIM)).astype(np.float32)
    tracing.enable(True)
    try:
        tracing.reset_counters()
        gen = co._layout_gen
        scores, hits = co.topk(q, 10, **flt)
        counts = tracing.counters()
    finally:
        tracing.enable(False)
        tracing.reset_counters()
    assert "search.graph_captures" not in counts
    assert "search.graph_replays" not in counts
    assert counts["search.calls"] == 1
    assert not co._graphs and co._layout_gen == gen
    # nprobe = nlist: every list is scanned, so the exact filtered top 10
    ok = np.ones(len(ids), bool)
    if "kinds" in flt:
        ok &= np.isin(kinds, flt["kinds"])
    if "agent" in flt:
        ok &= np.asarray(agents) == flt["agent"]
    ok &= ~np.isin(ids, flt.get("exclude_ids", []))
    exact = normalize_rows(q) @ normalize_rows(vecs).T
    exact[:, ~ok] = -np.inf
    want = np.argsort(-exact, axis=1, kind="stable")[:, :10]
    for j in range(b):
        assert hits[j] == [ids[r] for r in want[j]]
        np.testing.assert_allclose(scores[j], exact[j, want[j]], atol=1e-5)


def test_the_first_build_bumps_the_generation():
    index = TorchIvfIndex(DIM, nlist=8, nprobe=8, graph_degree=0,
                          device="cpu")
    gen = index._corpus._layout_gen
    index.insert_batch(["a", "b"], clustered(2))
    index._corpus.sync()
    assert index._corpus._ivf_dev is not None
    assert index._corpus._layout_gen == gen + 1


def test_in_place_writes_keep_the_generation():
    index, vecs, ids, _, _ = built()
    co = index._corpus
    gen, planes = co._layout_gen, co._ivf_dev
    index.insert_batch(["new0", "new1"], clustered(2, seed=5))
    index.insert_batch([ids[0]], vecs[1:2])          # an update in place
    index.remove(ids[2])
    co.sync()
    assert co._layout_gen == gen
    assert all(a is b for a, b in zip(co._ivf_dev, planes))


@pytest.mark.parametrize("step", ["grow_slots", "retrain", "compact",
                                  "release", "remove_all"])
def test_each_new_layout_bumps_the_generation(step):
    index, _, ids, _, _ = built()
    co = index._corpus
    gen = co._layout_gen
    if step == "grow_slots":
        with co._lock:
            assert co._grow_slots()
    elif step == "retrain":
        index.retrain()
    elif step == "compact":
        index.remove(ids[0])
        co.compact()
    elif step == "release":
        co.release()
    else:
        for i in ids:
            index.remove(i)
        co.sync()
    assert co._layout_gen > gen
    assert not co._graphs

