#!/usr/bin/env python3
"""One run of one benchmark cell of the port.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

In order: refuse without enough CUDA cards; make the cell's inputs on the
card from --seed; build the system under test through the port's public
API; warm the cell's own shapes; drive the traffic, closed loop, for
--seconds; with --trace 1, a further fixed number of calls under the
profiler; read the device's memory peak; free the program's state; run
the plain reference and compare every answer; print the compared numbers
beside their limits as the last lines on standard error and one JSON
object as the last line on standard output. --trace 0 reports the cell's
end-to-end metrics, --trace 1 its per-layer ones.

The cell, its configuration, traffic mix and metrics are found by name
(registry.py); this file names none of them.
"""

import time

T0 = time.perf_counter()          # set-up is counted from here

import argparse                   # noqa: E402
import gc                         # noqa: E402
import json                       # noqa: E402
import os                         # noqa: E402
import subprocess                 # noqa: E402
import sys                        # noqa: E402
import traceback                  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path          # noqa: E402
from typing import List, Optional  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np                # noqa: E402
import torch                      # noqa: E402

from portbench import registry, trace as tracing  # noqa: E402
from portbench.roofline import INT8_OPS_PER_S, bound_ms  # noqa: E402
from portbench.verdict import holds  # noqa: E402

#: calls after the first (which builds the index) that warm the cell's
#: shapes before the window
WARM_CALLS = 16
#: calls in the traced sub-window
PROFILE_CALLS = 300
#: top-level module names that must not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "cortex_tpu")
#: build and kernel caches of the program, at fixed paths in the checkout
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton",
              "TORCH_EXTENSIONS_DIR": "torch_extensions"}


@dataclass
class Run:
    """What a run measured, as the metric readers see it."""

    cfg: dict
    traffic: dict
    setup_s: float
    window_s: float                   # first call's start to last's end
    ops: int                          # operations the window attempted
    latency_s: np.ndarray             # per window call
    ops_per_call: np.ndarray
    dispatch_s: Optional[np.ndarray]  # per window call, traced runs
    finish_s: Optional[np.ndarray]
    least_s: float                    # the least time of one call's work
    values: dict = field(default_factory=dict)   # the judge's (recall)
    trace: Optional[tracing.TraceSummary] = None


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit_w(dev: torch.device) -> Optional[float]:
    """The card's power limit, read with nvidia-smi (None off the card)."""
    if dev.type != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", str(dev.index or 0)],
            capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run_cell(cell: registry.Cell, seed: int, seconds: float, trace: bool,
             dev: torch.device, *, t0: float, wrap=None):
    """One run of `cell` on dev. Returns (the result object, the lines
    that name each compared number beside its limit). `wrap`, for tests,
    wraps the system under test."""
    cfg, traffic = cell.cfg, cell.traffic
    if (traffic["loop"], traffic["clients"], traffic["in_flight"]) != (
            "closed", 1, 1):
        raise ValueError("the generator drives one closed-loop client with "
                         "one call in flight")
    cuda = dev.type == "cuda"
    sysmod = registry.system(cfg["system"])
    marks = [("imports", time.perf_counter())]
    data = sysmod.make_data(cfg, traffic, seed, dev)
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    marks.append(("inputs", time.perf_counter()))
    sut = sysmod.build(cfg, data, dev)
    marks.append(("build", time.perf_counter()))
    if wrap is not None:
        sut = wrap(sut)
    entry = sysmod.call_async if trace else sysmod.call
    batches = data.batches

    def one(j):
        q = batches[j % len(batches)]
        return entry(sut, q, traffic)() if trace else entry(sut, q, traffic)

    one(0)                              # uploads, trains, starts the graph
    marks.append(("first_call", time.perf_counter()))
    sysmod.wait_ready(sut, cfg)
    marks.append(("ready", time.perf_counter()))
    for j in range(1, WARM_CALLS + 1):
        one(j)
    if cuda:
        torch.cuda.synchronize(dev)
    marks.append(("warm", time.perf_counter()))

    outputs, lat, disp, fin, n_ops = [], [], [], [], []
    errors = []
    gc.collect()
    gc.freeze()
    j = 0
    start = time.perf_counter()
    setup_s = start - t0
    while True:
        bno = j % len(batches)
        q = batches[bno]
        ta = tm = time.perf_counter()
        try:
            if trace:
                done = entry(sut, q, traffic)
                tm = time.perf_counter()
                hits = done()
            else:
                hits = entry(sut, q, traffic)
        except Exception:               # noqa: BLE001 — judged as failed
            hits = None
            errors.append(traceback.format_exc(limit=3))
        tb = time.perf_counter()
        outputs.append((bno, hits))
        lat.append(tb - ta)
        disp.append(tm - ta)
        fin.append(tb - tm)
        n_ops.append(sysmod.ops(q))
        # what the window keeps is never collected again: the collector
        # scans the program's own objects only, as in a long-lived server
        gc.freeze()
        j += 1
        if tb - start >= seconds:
            break
    window_s = tb - start

    summary = None
    if trace:
        k0 = j
        outs, summary = tracing.profile(
            PROFILE_CALLS, lambda i: sysmod.call_async(
                sut, batches[(k0 + i) % len(batches)], traffic), dev)
        outputs += [((k0 + i) % len(batches), h) for i, h in enumerate(outs)]
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    sysmod.close(sut)
    del sut
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    verdict = sysmod.judge(cfg, traffic, data, outputs, dev)
    nbytes, nops = sysmod.least_work(cfg, traffic)
    run = Run(cfg=cfg, traffic=traffic, setup_s=setup_s, window_s=window_s,
              ops=int(sum(n_ops)), latency_s=np.asarray(lat),
              ops_per_call=np.asarray(n_ops),
              dispatch_s=np.asarray(disp) if trace else None,
              finish_s=np.asarray(fin) if trace else None,
              least_s=bound_ms(nbytes, nops, INT8_OPS_PER_S)[0] / 1e3,
              values=verdict.values, trace=summary)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = registry.metric(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else dev.type,
              "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
              "count": cell.chips, "memory_peak_bytes": int(peak),
              "power_limit_w": power_limit_w(dev)}
    result = {"correct": verdict.correct, "attempted": verdict.attempted,
              "failed": verdict.failed, "metrics": metrics, "device": device}
    if summary is not None:
        device["busy_s"] = summary.busy_s
        device["window_s"] = summary.window_s
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in summary.device_ops],
            "idle_gaps": [[n, s] for n, s in summary.idle_gaps]}
    lines = [f"error in a timed call (first of {len(errors)}):\n{errors[0]}"
             ] if errors else []
    steps, prev = [], t0
    for what, t in marks:
        steps.append(f"{what} {t - prev:.3f}")
        prev = t
    ends = np.cumsum(lat)       # each call's end, from the window's start
    per_s = np.bincount(np.minimum(ends.astype(int), int(window_s)),
                        weights=n_ops)
    lines.append(f"set-up s: {', '.join(steps)}; window calls {len(lat)}, "
                 f"distinct answers {verdict.values.get('distinct_answers')}"
                 f"; ops each second {per_s.astype(int).tolist()}")
    for name, (value, op, limit) in verdict.checks.items():
        ok = "ok" if holds(value, op, limit) else "FAIL"
        lines.append(f"check {name} {value!r} {op} {limit!r} {ok}")
    result["checks"] = {name: {"value": value, "limit": limit, "op": op}
                        for name, (value, op, limit)
                        in verdict.checks.items()}
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = registry.cell(registry.benchmark(), args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has {have}", file=sys.stderr)
        return 2
    cache = registry.ROOT / ".portbench_cache"
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(cache / sub)
    dev = torch.device("cuda", 0)
    result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                             dev, t0=T0)
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 3
    sys.stderr.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
