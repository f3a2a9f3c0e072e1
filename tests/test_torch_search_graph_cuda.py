"""The IVF search's captured CUDA graphs (cortex_tpu_torch/vector/ivf.py::
SearchGraph) against the eager chain, on the card.

Criterion: a graph-served dispatch returns the eager dispatch's values
and rows bit for bit (the same kernels in the same order), for batches of
1, 3 and 16 (a replay each) and 17 (eager), unfiltered and filtered by
kind, agent and exclusions, with and without spilled rows; the
overflowing filter runs eagerly. In-place upserts and removes are seen
by the next replay with no new capture; a retrain or a slot growth makes
exactly one. Two dispatches before either fetch each keep their answer,
threads that search at once each get theirs, and the profiler sees the
kernels a replay runs. Marked `cuda`: skipped without a GPU. This file
imports no jax; run it on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_search_graph_cuda.py
"""

import functools
import threading

import numpy as np
import pytest
import torch

from cortex_tpu_torch.ops.similarity import normalize_rows
from cortex_tpu_torch.utils import tracing
from cortex_tpu_torch.vector import ivf
from cortex_tpu_torch.vector.index import TorchFlatIndex
from cortex_tpu_torch.vector.ivf import TorchIvfIndex

pytestmark = pytest.mark.cuda

N, DIM, NLIST = 20_000, 768, 64
KINDS = ("fact", "event", "goal", "note")
FILTERS = {
    "none": (None, None, None),
    "kind": (["event", "note"], None, None),
    "agent": (None, "b", None),
    "excl": (None, None, [f"n{i}" for i in range(0, 400, 7)]),
    "all": (["fact", "goal"], "a", [f"n{i}" for i in range(1, 300, 11)]),
}
OVERFLOW = (None, None, [f"n{i}" for i in range(65)])


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def counters():
    tracing.enable(True)
    tracing.reset_counters()
    try:
        yield tracing.counters
    finally:
        tracing.enable(False)
        tracing.reset_counters()


def clustered(n, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((max(1, n // 20), DIM)).astype(np.float32)
    return (centers[rng.integers(0, len(centers), n)]
            + 0.35 * rng.standard_normal((n, DIM)).astype(np.float32))


@functools.lru_cache(maxsize=1)
def rows():
    return clustered(N)


def make_index(dev, spill):
    index = TorchIvfIndex(DIM, nlist=NLIST, nprobe=8, spill=spill,
                          graph_degree=0, device=dev)
    ids = [f"n{i}" for i in range(N)]
    index.insert_batch(ids, rows(), kinds=[KINDS[i % 4] for i in range(N)],
                       agents=[("a", "b", "c")[i % 3] for i in range(N)])
    index._corpus.sync()
    return index


@pytest.fixture(scope="module", params=[1.0, 0.0], ids=["spill", "nospill"])
def index(request, dev):
    index = make_index(dev, request.param)
    assert index._corpus._has_spill == (request.param > 0)
    yield index
    index.close()


def queries(b, seed):
    """b noisy copies of corpus rows."""
    rng = np.random.default_rng(seed)
    return (rows()[rng.choice(N, b, replace=False)]
            + 0.2 * rng.standard_normal((b, DIM)).astype(np.float32))


def dispatched(co, q, flt, k=10):
    """The dispatch's (values, rows) on the host."""
    v, i, *_ = co._dispatch(normalize_rows(q), k, flt)
    return v.cpu(), i.cpu()


def eager(co, q, flt, k=10):
    old = ivf.GRAPH_MAX_BATCH
    ivf.GRAPH_MAX_BATCH = 0
    try:
        return dispatched(co, q, flt, k)
    finally:
        ivf.GRAPH_MAX_BATCH = old


def assert_same(got, want):
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("case", list(FILTERS))
@pytest.mark.parametrize("b", [1, 3, 16, 17])
def test_replays_equal_the_eager_chain(index, counters, b, case):
    co, flt = index._corpus, FILTERS[case]
    for seed in range(3):
        q = queries(b, seed)
        assert_same(dispatched(co, q, flt), eager(co, q, flt))
    c = counters()
    if b <= ivf.GRAPH_MAX_BATCH:
        assert c["search.graph_replays"] == 3
        assert c.get("search.graph_captures", 0) <= 1
    else:
        assert "search.graph_replays" not in c
        assert "search.graph_captures" not in c


def test_the_overflowing_filter_runs_eagerly(index, counters):
    co = index._corpus
    q = queries(2, 9)
    got = dispatched(co, q, OVERFLOW)
    assert "search.graph_replays" not in counters()
    assert_same(got, eager(co, q, OVERFLOW))


def test_one_capture_a_key_and_a_replay_a_call(dev, counters):
    index = make_index(dev, 1.0)
    co = index._corpus
    for seed in range(5):
        for b in (1, 2):
            dispatched(co, queries(b, seed), FILTERS["none"])
    dispatched(co, queries(1, 7), FILTERS["kind"])
    c = counters()
    assert c["search.graph_captures"] == 3 == len(co._graphs)
    assert c["search.graph_replays"] == 11
    index.close()
    assert not co._graphs


def test_in_place_writes_reach_the_replay_without_a_capture(dev, counters):
    index = make_index(dev, 1.0)
    co = index._corpus
    q = queries(1, 3)
    dispatched(co, q, FILTERS["none"])
    gen = co._layout_gen
    rng = np.random.default_rng(5)
    fresh = normalize_rows(q + 0.01 * rng.standard_normal(q.shape)
                           .astype(np.float32))
    index.insert_batch(["fresh"], fresh, kinds=["fact"], agents=["a"])
    index.insert_batch([f"n{i}" for i in range(10)], clustered(10, seed=8))
    for i in range(10, 40):
        index.remove(f"n{i}")
    got = dispatched(co, q, FILTERS["none"])
    assert co._layout_gen == gen
    assert counters()["search.graph_captures"] == 1
    assert_same(got, eager(co, q, FILTERS["none"]))
    assert int(got[1][0, 0]) == co._row_of["fresh"]     # the nearest row
    scores, hits = co.topk(q, 10)
    assert hits[0][0] == "fresh"
    assert not {f"n{i}" for i in range(10, 40)} & set(hits[0])
    index.close()


@pytest.mark.parametrize("step", ["retrain", "grow_slots"])
def test_a_new_layout_captures_once_more(dev, counters, step):
    index = make_index(dev, 1.0)
    co = index._corpus
    q = queries(1, 4)
    dispatched(co, q, FILTERS["none"])
    if step == "retrain":
        index.retrain()
    else:
        with co._lock:
            assert co._grow_slots()
    assert not co._graphs
    for _ in range(3):
        got = dispatched(co, q, FILTERS["none"])
    c = counters()
    assert c["search.graph_captures"] == 2
    assert c["search.graph_replays"] == 4
    assert_same(got, eager(co, q, FILTERS["none"]))
    index.close()


def test_two_dispatches_before_either_fetch(index, counters):
    co = index._corpus
    qa, qb = queries(1, 11), queries(1, 12)
    want_a, want_b = eager(co, qa, FILTERS["none"]), eager(co, qb,
                                                            FILTERS["none"])
    da = co._dispatch(normalize_rows(qa), 10, FILTERS["none"])
    db = co._dispatch(normalize_rows(qb), 10, FILTERS["none"])
    assert_same((db[0].cpu(), db[1].cpu()), want_b)
    assert_same((da[0].cpu(), da[1].cpu()), want_a)
    fa = co.topk_async(qa, 10)
    fb = co.topk_async(qb, 10)
    for got, q in ((fb(), qb), (fa(), qa)):
        want = co.topk(q, 10)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


def test_threads_searching_at_once_each_get_their_answer(index):
    co = index._corpus
    work = [(queries(b, 20 + j), FILTERS[("none", "kind", "all")[j % 3]])
            for j, b in enumerate((1, 2, 5, 1, 16, 3, 1, 2))]
    want = [eager(co, q, flt) for q, flt in work]
    errors = []

    def run(j):
        try:
            for _ in range(20):
                assert_same(dispatched(co, *work[j]), want[j])
        except Exception as e:       # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(j,))
               for j in range(len(work))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]


def test_the_profiler_sees_the_kernels_of_a_replay(index):
    from torch.profiler import ProfilerActivity, profile
    co = index._corpus
    q = queries(1, 30)
    dispatched(co, q, FILTERS["none"])       # captured before the profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            dispatched(co, q, FILTERS["none"])
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if (getattr(e, "device_time_total", 0)
                 or getattr(e, "cuda_time_total", 0)) > 0]
    assert any("probed_scan" in n for n in names), names


def test_a_flat_index_never_captures(dev, counters):
    index = TorchFlatIndex(DIM, device=dev)
    index.insert_batch([f"n{i}" for i in range(5000)], clustered(5000))
    index.search_batch(queries(2, 1), 10)
    c = counters()
    assert c["search.calls"] == 1
    assert "search.graph_captures" not in c
    assert "search.graph_replays" not in c
    index.close()
