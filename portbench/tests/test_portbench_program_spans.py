"""The readers of the program's own regions, counters and build spans
(program_spans.py): the mean per call from a planted table, None where
there is nothing to read, and a CPU run of each cell that reports every
such metric its path records."""

import dataclasses
import time

import pytest

from cortex_tpu_torch.utils import tracing as program
from portbench import registry, run
from portbench import trace as bench_trace
from conftest import tiny

CELLS = tuple(w["name"] for w in registry.benchmark()["workloads"])
#: the planted tables: 300 calls of search.dispatch, region totals (s),
#: build spans (s) and counters; WANT: each metric's reading of them
CALLS = 300
PLANTED_SPANS = {"search.dispatch": 0.6, "search.prepare": 0.09,
                 "search.launch": 0.3, "search.fetch": 0.06,
                 "search.hits": 0.12, "search.expand": 0.045,
                 "search.rerank": 0.075, "index.insert": 11.5,
                 "index.layout": 14.25}
PLANTED_COUNTS = {"search.queries": 600, "search.rerank_rows": 345600,
                  "search.expanded_rows": 153000}
WANT = {
    "prepare_ms": 0.09 / CALLS * 1e3, "launch_ms": 0.3 / CALLS * 1e3,
    "fetch_ms": 0.06 / CALLS * 1e3, "hits_ms": 0.12 / CALLS * 1e3,
    "expand_ms": 0.045 / CALLS * 1e3, "rerank_ms": 0.075 / CALLS * 1e3,
    "rerank_rows": 345600 / 600, "expanded_rows": 153000 / 600,
    "insert_s": 11.5, "layout_s": 14.25}
NEW = sorted(m["name"] for m in registry.benchmark()["per_layer"]
             if m["name"].split(".")[0] in WANT)
#: what each configuration's path records
FLAT = {"prepare_ms", "launch_ms", "fetch_ms", "hits_ms", "insert_s",
        "layout_s"}
IVF = FLAT | {"expand_ms", "rerank_ms", "rerank_rows", "expanded_rows"}


def traced(busy_s=0.5):
    return bench_trace.TraceSummary(calls=CALLS, window_s=1.0,
                                    busy_s=busy_s, device_ops=[],
                                    idle_gaps=[])


class FakeRun:
    def __init__(self, trace):
        self.trace = trace


@pytest.fixture
def planted(monkeypatch):
    spans = {n: program.SpanStats(count=CALLS if n.startswith("search.")
                                  else 1, total_s=s, max_s=s)
             for n, s in PLANTED_SPANS.items()}
    spans["search.hits"].count = 3 * CALLS        # three places a call
    monkeypatch.setattr(program, "stats", lambda: dict(spans))
    monkeypatch.setattr(program, "counters", lambda: dict(PLANTED_COUNTS))
    return spans


def test_every_new_metric_has_a_reader_and_an_entry():
    assert {n.split(".")[0] for n in NEW} == set(WANT)
    for name in NEW:
        assert callable(registry.metric(name).read)


@pytest.mark.parametrize("name", NEW)
def test_a_reader_reads_its_planted_table(name, planted):
    got = registry.metric(name).read(FakeRun(traced()))
    assert isinstance(got, float)
    assert got == pytest.approx(WANT[name.split(".")[0]], rel=1e-12)


@pytest.mark.parametrize("name", NEW)
def test_a_reader_finds_nothing_where_nothing_is(name, planted, monkeypatch):
    read = registry.metric(name).read
    # no trace, or a traced window with no device work: nothing read
    assert read(FakeRun(None)) is None
    assert read(FakeRun(traced(busy_s=0.0))) is None
    # the region or counter absent (the flat path re-ranks nothing on
    # the host), or the program without counters (an older program)
    monkeypatch.setattr(program, "stats", lambda: {})
    monkeypatch.setattr(program, "counters", lambda: {})
    assert read(FakeRun(traced())) is None
    monkeypatch.delattr(program, "counters")
    assert read(FakeRun(traced())) is None


@pytest.mark.parametrize("name", CELLS)
def test_a_cpu_run_reports_what_its_path_records(name, cpu, monkeypatch):
    """A traced run at the CPU size, its profile's busy time planted (the
    CPU's trace holds no device work): every new metric of the cell that
    its path records is reported, and every metric of the cell's before."""
    monkeypatch.setattr(run, "PROFILE_CALLS", 20)
    profile = bench_trace.profile

    def with_busy_time(*a, **kw):
        outs, summary = profile(*a, **kw)
        return outs, dataclasses.replace(summary,
                                         busy_s=summary.window_s / 2)

    monkeypatch.setattr(run.tracing, "profile", with_busy_time)
    program.reset_stats()
    program.reset_counters()
    cell = tiny(name)
    result, _ = run.run_cell(cell, 2 ** 31 + 7, 0.5, True, cpu,
                             t0=time.perf_counter())
    assert result["correct"] is True
    reported = set(result["metrics"])
    assert reported == {m["name"] for m in cell.per_layer}
    path = IVF if cell.cfg["system"] == "ivf" else FLAT
    new = {m.split(".")[0] for m in reported if m.split(".")[0] in WANT}
    assert new == path
    metrics = result["metrics"]
    assert all(metrics[m]["value"] > 0 for m in reported
               if m.split(".")[0] in WANT)
    if cell.cfg["system"] == "ivf":
        # at most the device's candidates and the graph's rows a query
        assert (metrics["expanded_rows.b1"]["value"]
                < metrics["rerank_rows.b1"]["value"])
    assert not program.active()
