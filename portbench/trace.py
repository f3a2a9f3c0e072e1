"""The traced sub-window: a fixed number of calls under torch.profiler,
each split into the benchmark's own spans `dispatch` (the call of the
async entry until it returns) and `finish` (until the returned callable
yields the answers), and what the device did meanwhile.

From the profiler's trace: the window (the first span's start to the
last one's end), the device's busy time (the union of every kernel,
copy and set on the device inside it), the device operations that took
the most time, and the idle time by what the host was inside (the span,
and the innermost host operator where one was running).
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import warnings
from collections import defaultdict
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

DISPATCH, FINISH = "dispatch", "finish"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10
#: host operators looked at, back from a gap's middle, for the innermost
#: one running there
_OP_LOOKBACK = 64


@dataclass
class TraceSummary:
    calls: int
    window_s: float
    busy_s: float
    device_ops: List[Tuple[str, float]]     # (name, seconds), most first
    idle_gaps: List[Tuple[str, float]]      # (host activity, seconds)


def profile(n: int, dispatch, dev: torch.device):
    """Run dispatch(j)() for j < n under the profiler. Returns (the
    answers, None for a call that raised; the summary, or None when the
    trace holds no span)."""
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    outs = []
    warnings.filterwarnings("ignore", message=".*Profiler clears events")
    with torch_profile(activities=acts) as prof:
        for j in range(n):
            try:
                with record_function(DISPATCH):
                    fin = dispatch(j)
                with record_function(FINISH):
                    outs.append(fin())
            except Exception:           # noqa: BLE001 — judged as failed
                outs.append(None)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return outs, summarize(events, n)


def _intervals(events, cats, names=None):
    return sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                   e.get("name", ""))
                  for e in events
                  if e.get("ph") == "X" and e.get("cat") in cats
                  and (names is None or e.get("name") in names))


def _union(iv, lo, hi):
    """Merged [start, end) pieces of the intervals, clipped to [lo, hi]."""
    out = []
    for s, e, _ in iv:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _covering(iv, starts, t) -> Optional[str]:
    """Name of the latest-starting interval that holds time t."""
    j = bisect.bisect_right(starts, t) - 1
    for i in range(j, max(-1, j - _OP_LOOKBACK), -1):
        if iv[i][0] <= t <= iv[i][1]:
            return iv[i][2]
    return None


def summarize(events, calls: int) -> Optional[TraceSummary]:
    """The summary of a chrome trace's events (times in microseconds)."""
    spans = _intervals(events, ("user_annotation",), (DISPATCH, FINISH))
    if not spans:
        return None
    lo, hi = spans[0][0], max(e for _, e, _ in spans)
    dev = _intervals(events, DEVICE_CATS)
    busy = _union(dev, lo, hi)
    per_op = defaultdict(float)
    for s, e, name in dev:
        per_op[name] += (e - s) * 1e-6
    ops = _intervals(events, ("cpu_op",))
    span_starts = [s for s, _, _ in spans]
    op_starts = [s for s, _, _ in ops]
    idle = defaultdict(float)
    edges = [lo] + [x for piece in busy for x in piece] + [hi]
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = (g0 + g1) / 2
        what = _covering(spans, span_starts, mid) or "between"
        op = _covering(ops, op_starts, mid)
        idle[f"{what}/{op}" if op else what] += (g1 - g0) * 1e-6
    return TraceSummary(
        calls=calls, window_s=(hi - lo) * 1e-6,
        busy_s=sum(e - s for s, e in busy) * 1e-6,
        device_ops=sorted(per_op.items(), key=lambda kv: -kv[1])[:TOP],
        idle_gaps=sorted(idle.items(), key=lambda kv: -kv[1])[:TOP])
