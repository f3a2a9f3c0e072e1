"""The port's hot-path tracing (cortex_tpu_torch/utils/tracing.py) on the
search path and the index build, on the CPU with tiny flat and IVF
indexes.

Regions record only while tracing is active (a torch.profiler session,
`enable(True)`, or CORTEX_TRACE=1 at import); the build's spans always.
Each search records its path's regions, its two halves share one call
id, the counters equal counts taken from the same candidate arrays, the
profiler's Chrome trace nests the regions between the caller's span and
the aten operators they launch, and concurrent searches add up exactly.
The batchers' wait and sizes and the /metrics export are covered too.
"""

import asyncio
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import profile, record_function

from cortex_tpu_torch.server.batcher import SearchBatcher
from cortex_tpu_torch.server.metrics import CortexMetrics
from cortex_tpu_torch.utils import tracing
from cortex_tpu_torch.vector import TorchIvfIndex
from cortex_tpu_torch.vector.index import TorchFlatIndex

REPO = Path(__file__).resolve().parent.parent
DIM = 32
ROWS = 3000
BATCH = 4
K = 5
FLAT_REGIONS = {"search.dispatch", "search.prepare", "search.launch",
                "search.finish", "search.fetch", "search.hits"}
IVF_REGIONS = FLAT_REGIONS | {"search.expand", "search.rerank"}
#: regions that run once per search call (search.prepare and
#: search.hits run in more than one place of a call)
ONCE = {"search.dispatch", "search.launch", "search.finish",
        "search.fetch", "search.expand", "search.rerank"}
BUILD_SPANS = {"index.insert", "index.layout"}


@pytest.fixture(autouse=True)
def clean_tables():
    tracing.enable(False)
    tracing.reset_stats()
    tracing.reset_counters()
    yield
    tracing.enable(False)
    tracing.reset_stats()
    tracing.reset_counters()


def rows(n=ROWS, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((40, DIM)).astype(np.float32)
    x = centers[rng.integers(0, 40, n)] + 0.3 * rng.standard_normal(
        (n, DIM)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def build(kind, x=None, **kw):
    """A tiny index of `kind`, its rows inserted and its layout built
    by a first search (tracing off), the build's spans then cleared."""
    x = rows() if x is None else x
    if kind == "flat":
        idx = TorchFlatIndex(DIM, search_path="quant", device="cpu", **kw)
    else:
        idx = TorchIvfIndex(DIM, nlist=16, nprobe=4, graph_degree=8,
                            device="cpu")
    idx.insert_batch([str(i) for i in range(len(x))], x)
    idx.search_batch(x[:1], K)
    if kind == "ivf":
        assert idx.index_info()["graph_built"]
    tracing.reset_stats()
    return idx, x


def search_regions():
    return {n: s for n, s in tracing.stats().items()
            if n.startswith("search.")}


def test_off_records_nothing_and_region_is_the_shared_no_op():
    assert not tracing.active()
    assert tracing.region("a") is tracing.region("b") is tracing._NO_REGION
    with tracing.region("a") as r:
        assert r.call is None
    tracing.count("c", 3)
    tracing.elapsed("d", 0)
    for kind in ("flat", "ivf"):
        idx, x = build(kind)
        out = idx.search_batch(x[:BATCH], K)
        assert len(out) == BATCH
        assert tracing.stats() == {}
        assert tracing.counters() == {}
        assert tracing.regions() == []
        assert tracing.self_times() == {}


@pytest.mark.parametrize("kind", ["flat", "ivf"])
@pytest.mark.parametrize("mode", ["profiler", "enable"])
def test_a_search_records_its_path_once_per_call(kind, mode):
    idx, x = build(kind)
    off = idx.search_batch(x[:BATCH], K)
    calls = 3
    if mode == "profiler":
        with profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            assert tracing.active()
            got = [idx.search_batch(x[:BATCH], K) for _ in range(calls)]
    else:
        tracing.enable(True)
        got = [idx.search_batch(x[:BATCH], K) for _ in range(calls)]
        tracing.enable(False)
    assert not tracing.active()
    assert all(g == off for g in got)          # results do not change
    st = search_regions()
    want = IVF_REGIONS if kind == "ivf" else FLAT_REGIONS
    assert set(st) == want
    for name, s in st.items():
        if name in ONCE:
            assert s.count == calls, name
        else:
            assert s.count >= calls, name
        assert s.total_s > 0
    c = tracing.counters()
    assert c["search.calls"] == calls
    assert c["search.queries"] == calls * BATCH
    assert "search.redispatch" not in c
    assert ("search.rerank_rows" in c) == (kind == "ivf")
    assert ("search.expanded_rows" in c) == (kind == "ivf")
    # hits_ms sums the regions: a nested search.hits would count twice
    assert not [r for r in tracing.regions()
                if r.name == "search.hits" and r.parent == "search.hits"]


def test_self_time_leaves_out_the_enclosed_regions():
    tracing.enable(True)
    with tracing.region("outer") as outer:
        time.sleep(0.02)
        with tracing.region("inner") as inner:
            time.sleep(0.06)
    tracing.enable(False)
    assert inner.call == outer.call
    st, own = tracing.stats(), tracing.self_times()
    assert st["outer"].total_s >= 0.08 and st["inner"].total_s >= 0.06
    # the outer's own 20 ms, without the inner's 60
    assert 0.02 <= own["outer"] < 0.06
    assert own["inner"] == st["inner"].total_s
    (rin, rout) = tracing.regions()
    assert (rin.name, rin.parent, rout.name, rout.parent) == (
        "inner", "outer", "outer", None)
    assert rout.start_ns <= rin.start_ns <= rin.end_ns <= rout.end_ns


@pytest.mark.parametrize("kind", ["flat", "ivf"])
def test_the_roots_self_time_is_what_their_children_leave(kind):
    idx, x = build(kind)
    tracing.enable(True)
    idx.search_batch(x[:BATCH], K)
    tracing.enable(False)
    recs = tracing.regions()
    selfs = tracing.self_times()
    for root in ("search.dispatch", "search.finish"):
        (r,) = [r for r in recs if r.name == root]
        assert r.parent is None
        kids = [c for c in recs if c.parent == root and c.call == r.call]
        assert kids and all(r.start_ns <= c.start_ns <= c.end_ns
                            <= r.end_ns for c in kids)
        left = (r.end_ns - r.start_ns) - sum(c.end_ns - c.start_ns
                                             for c in kids)
        # the children's scopes, their bookkeeping included, are left out
        assert 0 <= selfs[root] <= left * 1e-9 + 1e-9


def test_the_halves_of_a_call_share_one_id():
    idx, x = build("ivf")
    tracing.enable(True)
    finishes = [idx.search_batch_async(x[j:j + 1], K) for j in range(3)]
    for f in reversed(finishes):               # finished out of order
        f()
    tracing.enable(False)
    recs = tracing.regions()
    by_call = {}
    for r in recs:
        by_call.setdefault(r.call, []).append(r.name)
    assert len(by_call) == 3
    for names in by_call.values():
        assert names.count("search.dispatch") == 1
        assert names.count("search.finish") == 1
        assert set(names) == IVF_REGIONS
    # dispatched in order, finished in reverse: the ids pair the halves
    d = [r.call for r in recs if r.name == "search.dispatch"]
    f = [r.call for r in recs if r.name == "search.finish"]
    assert f == d[::-1]


def test_counters_equal_counts_from_the_candidate_arrays(monkeypatch):
    idx, x = build("ivf")
    co = idx._corpus
    seen = {}
    expand, rerank = co._expand_candidates, co._rerank_host

    def spy_expand(i, valid, q_np, flt):
        i2, v2 = expand(i, valid, q_np, flt)
        w = i.shape[1]
        for b in range(i.shape[0]):
            # the distinct live rows the graph added that the device's
            # own candidates did not hold
            added = set(i2[b, w:][v2[b, w:]].tolist())
            assert not added & set(i[b][valid[b]].tolist())
            assert all(co._live_h[r] for r in added)
            seen.setdefault("expanded", []).append(len(added))
        return i2, v2

    def spy_rerank(i, valid, q_np, kk):
        seen.setdefault("reranked", []).append(np.count_nonzero(valid))
        return rerank(i, valid, q_np, kk)

    monkeypatch.setattr(co, "_expand_candidates", spy_expand)
    monkeypatch.setattr(co, "_rerank_host", spy_rerank)
    tracing.enable(True)
    for s0 in (0, 8, 16):
        idx.search_batch(x[s0:s0 + 8], K)
    tracing.enable(False)
    c = tracing.counters()
    assert c["search.expanded_rows"] == sum(seen["expanded"]) > 0
    assert c["search.rerank_rows"] == sum(seen["reranked"]) > 0
    # the device's candidates plus the graph's rows are what is re-ranked
    assert c["search.rerank_rows"] > c["search.expanded_rows"]


def test_flat_host_rerank_counts_its_candidates():
    # bf16 rows keep no exact copy on the device: K1 alone, and the
    # exact re-rank of its candidates on the host, with no expansion
    idx, x = build("flat", storage_dtype="bfloat16")
    tracing.enable(True)
    idx.search_batch(x[:BATCH], K)
    tracing.enable(False)
    co = idx._corpus
    cand = co._cand_count(co._k_bucket(K)[1])
    c = tracing.counters()
    assert c["search.rerank_rows"] == BATCH * cand
    assert "search.expanded_rows" not in c
    assert "search.rerank" in tracing.stats()
    assert "search.expand" not in tracing.stats()


def test_the_chrome_trace_nests_the_regions(tmp_path):
    idx, x = build("ivf")
    with profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with record_function("caller"):
            idx.search_batch(x[:BATCH], K)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]

    def spans(name, cat):
        return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                for e in events if e["name"] == name and e.get("cat") == cat]

    def inside(a, b):
        return b[0] <= a[0] and a[1] <= b[1]

    (caller,) = spans("caller", "user_annotation")
    for name in IVF_REGIONS:
        got = spans(name, "user_annotation")
        assert got, name
        assert all(inside(g, caller) for g in got), name
    (launch,) = spans("search.launch", "user_annotation")
    (disp,) = spans("search.dispatch", "user_annotation")
    (fin,) = spans("search.finish", "user_annotation")
    assert inside(launch, disp)
    assert all(inside(r, fin) for n in ("search.fetch", "search.expand",
                                        "search.rerank")
               for r in spans(n, "user_annotation"))
    topk = spans("aten::topk", "cpu_op")
    assert topk and all(inside(t, launch) for t in topk)


def test_two_threads_add_up_exactly():
    idx, x = build("flat")
    n, errors = 25, []

    def worker(seed):
        try:
            for j in range(n):
                s0 = (seed * 97 + j * 13) % (ROWS - BATCH)
                idx.search_batch(x[s0:s0 + BATCH], K)
        except Exception as e:          # noqa: BLE001 — reported below
            errors.append(e)

    tracing.enable(True)
    threads = [threading.Thread(target=worker, args=(t,)) for t in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    tracing.enable(False)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    c = tracing.counters()
    assert c["search.calls"] == 2 * n
    assert c["search.queries"] == 2 * n * BATCH
    st = tracing.stats()
    for name in ONCE & FLAT_REGIONS:
        assert st[name].count == 2 * n, name
    recs = tracing.regions()
    calls = {r.call for r in recs if r.name == "search.dispatch"}
    assert len(calls) == 2 * n
    assert {r.call for r in recs if r.name == "search.finish"} == calls


def test_no_update_is_lost_across_threads():
    """More threads than cores, switching as often as the interpreter
    allows: every region, self time and counter update lands."""
    n_threads, n = 16, 300

    def work():
        for _ in range(n):
            with tracing.region("stress.outer"):
                with tracing.region("stress.inner"):
                    tracing.count("stress.count", 2)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        tracing.enable(True)
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        tracing.enable(False)
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    st = tracing.stats()
    assert st["stress.outer"].count == st["stress.inner"].count \
        == n_threads * n
    assert tracing.counters() == {"stress.count": 2 * n_threads * n}
    own = tracing.self_times()
    assert own["stress.inner"] == pytest.approx(st["stress.inner"].total_s)
    assert 0 <= own["stress.outer"] < st["stress.outer"].total_s
    recs = tracing.regions()
    assert len(recs) == tracing.RING_SIZE     # bounded: the newest kept
    assert all(r.parent == "stress.outer" for r in recs
               if r.name == "stress.inner")


@pytest.mark.parametrize("kind", ["flat", "ivf"])
def test_the_build_spans_record_once_per_build_with_tracing_off(kind):
    x = rows()
    if kind == "flat":
        idx = TorchFlatIndex(DIM, search_path="quant", device="cpu")
    else:
        idx = TorchIvfIndex(DIM, nlist=16, nprobe=4, graph_degree=8,
                            device="cpu")
    idx.insert_batch([str(i) for i in range(ROWS)], x)
    assert set(tracing.stats()) == {"index.insert"}
    for _ in range(3):
        idx.search_batch(x[:BATCH], K)
    st = tracing.stats()
    assert set(st) == BUILD_SPANS
    assert st["index.insert"].count == 1
    assert st["index.layout"].count == 1
    assert st["index.layout"].total_s > 0
    assert tracing.counters() == {}


def test_cortex_trace_is_read_at_import():
    code = ("from cortex_tpu_torch.utils import tracing; "
            "print(tracing.active())")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    for value, want in (("1", "True"), ("0", "False")):
        env["CORTEX_TRACE"] = value
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr[-2000:]
        assert out.stdout.strip() == want


class FakeEmbedder:
    def embed_batch(self, texts):
        return np.ones((len(texts), DIM), np.float32)


class FakeIndex:
    def search_batch(self, embs, k, flt=None):
        return [[("a", 1.0)] for _ in range(len(embs))]


@pytest.mark.parametrize("on", [True, False])
def test_the_search_batcher_records_its_wait_and_sizes(on):
    async def go():
        b = SearchBatcher(FakeIndex(), FakeEmbedder(), max_batch=64,
                          max_wait_ms=5.0)
        out = await asyncio.gather(*(b.search(f"q{j}", 1)
                                     for j in range(3)))
        await b.close()
        return out

    tracing.enable(on)
    out = asyncio.run(go())
    tracing.enable(False)
    assert out == [[("a", 1.0)]] * 3
    if on:
        assert tracing.counters() == {"server.batches": 1,
                                      "server.batch_queries": 3}
        wait = tracing.stats()["server.batch_wait"]
        assert wait.count == 1 and wait.total_s >= 0.004
    else:
        assert tracing.counters() == {} and tracing.stats() == {}


def test_metrics_render_the_span_table_while_tracing():
    idx, x = build("flat")
    m = CortexMetrics()
    assert "cortex_span_" not in m.render()
    tracing.enable(True)
    idx.search_batch(x[:BATCH], K)
    text = m.render()
    tracing.enable(False)
    assert "# TYPE cortex_span_seconds_total counter" in text
    assert 'cortex_span_calls_total{span="search.dispatch"} 1' in text
    assert 'cortex_span_seconds_total{span="search.finish"} ' in text
    assert (f'cortex_trace_count_total{{name="search.queries"}} {BATCH}'
            in text)
