"""The run loop on the CPU at a tiny size: the last line's schema, the
rate and tail arithmetic, and a timed path broken underneath that the
comparison must catch. The command itself refuses without a card."""

import ast
import json
import subprocess
import sys
import time

import numpy as np
import pytest

from portbench import registry, run, stats
from conftest import ROOT, tiny

CELLS = tuple(w["name"] for w in registry.benchmark()["workloads"])
SEED = 2 ** 31 + 3


def run_tiny(cell, cpu, trace=False, seconds=0.5, wrap=None):
    result, lines = run.run_cell(cell, SEED, seconds, trace, cpu,
                                 t0=time.perf_counter(), wrap=wrap)
    return result, lines


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct_and_keeps_the_schema(name, cpu, monkeypatch):
    monkeypatch.setattr(run, "PROFILE_CALLS", 20)
    cell = tiny(name)
    for trace in (False, True):
        result, lines = run_tiny(cell, cpu, trace)
        assert list(result) == (["correct", "attempted", "failed", "metrics",
                                 "device"] + (["breakdown"] if trace else [])
                                + ["checks"])
        assert result["correct"] is True and result["failed"] == 0
        assert result["attempted"] > 0
        dev = result["device"]
        assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
        want = cell.per_layer if trace else cell.end_to_end
        units = {m["name"]: m["unit"] for m in want}
        assert set(result["metrics"]) <= set(units)
        for m, v in result["metrics"].items():
            assert v["unit"] == units[m] and isinstance(v["value"], float)
        if trace:
            # no device in the CPU's trace: the device readers read nothing
            assert {m.split(".")[0] for m in result["metrics"]} == {
                "dispatch_ms", "finish_ms"}
            assert dev["busy_s"] == 0 and dev["window_s"] > 0
            assert all(len(v) <= 10 for v in result["breakdown"].values())
        else:
            assert set(result["metrics"]) == set(units)
            assert result["metrics"]["recall_at_10"]["value"] > 0.99
        names = [ln.split()[1] for ln in lines if ln.startswith("check ")]
        assert names == list(result["checks"])
        assert all(ln.endswith(" ok") for ln in lines
                   if ln.startswith("check "))
        json.dumps(result, allow_nan=False)


class Broken:
    """The system under test with one fault planted in its answers."""

    def __init__(self, index, fault):
        self._index, self._fault, self._last = index, fault, None

    def __getattr__(self, name):
        return getattr(self._index, name)

    def _break(self, hits):
        if self._fault == "stale":         # the previous call's answers
            hits, self._last = (self._last or hits), hits
        elif self._fault == "half":        # half the batch left out
            h = len(hits) // 2
            hits = hits[:h] + hits[:h]
        elif self._fault == "altered":     # one answer altered at its source
            (i, s), rest = hits[0][0], hits[0][1:]
            hits = [[(str((int(i) + 1) % 6000), s)] + rest] + hits[1:]
        return hits

    def search_batch(self, q, k, flt=None, *, refine=True):
        return self._break(self._index.search_batch(q, k, refine=refine))

    def search_batch_async(self, q, k, flt=None, *, refine=True):
        done = self._index.search_batch_async(q, k, refine=refine)
        return lambda: self._break(done())


@pytest.mark.parametrize("name,fault", [
    (c, f) for c in CELLS for f in ("stale", "half", "altered")
    if not (f == "half" and tiny(c).traffic["batch"] == 1)])
def test_a_broken_timed_path_is_not_correct(name, fault, cpu):
    result, lines = run_tiny(tiny(name), cpu,
                             wrap=lambda idx: Broken(idx, fault))
    assert result["correct"] is False, lines
    assert any(ln.endswith(" FAIL") for ln in lines)


def test_a_stall_inside_the_window_moves_rate_and_tail(cpu):
    """Every fifth call stalls 50 ms: the rate falls with all the time
    counted, the 95th percentile lands in the stalls, the median not."""
    cell = tiny("flat-1m-768.b64")
    calls = [0]

    class Stalling(Broken):
        def _break(self, hits):
            calls[0] += 1
            if calls[0] % 5 == 0:
                time.sleep(0.05)
            return hits

    smooth, _ = run_tiny(cell, cpu, seconds=1.0)
    stalled, _ = run_tiny(cell, cpu, seconds=1.0,
                          wrap=lambda idx: Stalling(idx, None))
    m0, m1 = smooth["metrics"], stalled["metrics"]
    assert stalled["correct"] is True
    assert m1["latency_p95_ms"]["value"] >= 50
    assert m0["latency_p95_ms"]["value"] < 25
    assert m1["latency_p50_ms"]["value"] < 25
    # at least 10 ms a call on average: at most 6,400 queries a second
    assert m1["ops_per_s"]["value"] <= 6400
    assert m0["ops_per_s"]["value"] > 2 * m1["ops_per_s"]["value"]


def test_rate_and_percentiles_count_every_operation():
    # 9 calls of 64 queries at 1 ms and one of 64 at 100 ms: p95 over the
    # 640 queries falls in the slow call's, the median does not
    lat = np.array([0.001] * 9 + [0.1])
    ops = np.full(10, 64)
    assert stats.percentile(lat, ops, 50) == pytest.approx(0.001)
    assert stats.percentile(lat, ops, 95) == pytest.approx(0.1)
    assert stats.rate(int(ops.sum()), float(lat.sum())) == pytest.approx(
        640 / 0.109)


def test_the_command_refuses_without_a_card():
    proc = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         "flat-1m-768.b64", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, time, torch\n"
        f"sys.path[:0] = [{str(ROOT)!r}, "
        f"{str(ROOT / 'portbench' / 'tests')!r}]\n"
        "from conftest import tiny\n"
        "from portbench import run\n"
        "res, _ = run.run_cell(tiny('ivf-1m-768.b1'), 5, 0.3, False,\n"
        "                      torch.device('cpu'), t0=time.perf_counter())\n"
        "assert res['correct']\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    loaded = set(json.loads(proc.stdout.strip().splitlines()[-1]
                            .replace("'", '"')))
    assert "cortex_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "cortex_tpu"}


def _imports(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_source_imports_jax_or_reads_the_old_benchmarks():
    old = ("chip_" + "smoke", "bench" + ".py", "benches" + "/")
    for path in registry.HERE.rglob("*.py"):
        tops = _imports(path)
        assert not tops & {"jax", "jaxlib", "flax", "cortex_tpu",
                           "chip_smoke", "bench", "benches"}, path
        if path.name == "test_portbench_run.py":
            continue
        tree = ast.parse(path.read_text())
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
                and n.body and isinstance(n.body[0], ast.Expr)}
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docs):
                assert not any(o in node.value for o in old), path
