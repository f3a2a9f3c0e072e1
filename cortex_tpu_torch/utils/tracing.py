"""Timed spans with aggregate stats, and the hot path's regions and
counters.

`SpanStats`, `stats`, `reset_stats`, `span` and `timed` are verbatim
copies of cortex_tpu/utils/tracing.py's: `span()` is a timed scope that
logs its duration and feeds a process-wide table, `timed` its decorator
form. They record on every call, so they mark work that runs once or
rarely: the auto-linker's legs (linker.scan, linker.search, ...) and the
index build (index.insert, index.layout).

`region(name)` is the hot path's span. It records only while tracing is
active (`active()`: a torch.profiler session records, `enable(True)` was
called, or CORTEX_TRACE=1 was set when this module was imported);
otherwise it returns one shared no-op scope and reads no clock. An
active region feeds the same table as `span()`, enters
`torch.profiler.record_function(name)` under the profiler (so it lies in
the Kineto trace on the clock of the kernels and copies it launches),
adds its self time (its duration less the scopes of the regions it
encloses) to `self_times()`, and keeps its record (`RegionRecord`) in a
ring of the last RING_SIZE. A region inherits the call id of the region that
encloses it; a root takes a new one, or the one it is given, so that the
two halves of one search share theirs. `count(name, n)` adds to a
counter while tracing is active (`counters()`); `reset_counters()`
clears the counters, the self times and the ring.

`profile_trace(log_dir)` is the reference's device-profile scope on
torch.profiler: the host's and, with CUDA, the card's activity, written
as a Chrome trace into log_dir.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import logging
import os
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Iterator, List, NamedTuple, Optional

from torch.autograd import profiler as _autograd_profiler

log = logging.getLogger("cortex.trace")


@dataclass
class SpanStats:
    count: int = 0
    total_s: float = 0.0
    max_s: float = 0.0

    @property
    def mean_ms(self) -> float:
        return (self.total_s / self.count * 1e3) if self.count else 0.0


_stats: Dict[str, SpanStats] = defaultdict(SpanStats)


def stats() -> Dict[str, SpanStats]:
    return dict(_stats)


def reset_stats() -> None:
    _stats.clear()


@contextlib.contextmanager
def span(name: str, *, level: int = logging.DEBUG) -> Iterator[None]:
    """Timed scope: logs duration and feeds the aggregate table."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        s = _stats[name]
        s.count += 1
        s.total_s += dt
        s.max_s = max(s.max_s, dt)
        log.log(level, "%s took %.1fms", name, dt * 1e3)


def timed(name: str = ""):
    """Decorator form of span()."""
    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(label):
                return fn(*args, **kwargs)
        return wrapper
    return deco


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[None]:
    """Capture a torch.profiler trace (Chrome trace JSON in log_dir) for
    the scope. No-ops with a warning when the profiler can't start
    (e.g. nested inside another profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    prof = None
    try:
        if torch.autograd.profiler._is_profiler_enabled:
            raise RuntimeError("a profiler is already running")
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        p = profile(activities=acts)
        p.start()
        prof = p
    except RuntimeError as e:
        log.warning("profiler unavailable: %s", e)
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.stop()
                os.makedirs(log_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(
                    log_dir, f"trace.{os.getpid()}.{time.time_ns()}.json"))
            except (RuntimeError, OSError) as e:
                log.warning("profiler trace not written: %s", e)


# ---------------------------------------------------------------- regions

#: region records kept, the newest last (`regions()`)
RING_SIZE = 4096


class RegionRecord(NamedTuple):
    name: str
    start_ns: int                 # time.perf_counter_ns()
    end_ns: int
    parent: Optional[str]         # the enclosing region's name
    call: int                     # shared by the halves of one search


_on = os.environ.get("CORTEX_TRACE", "") == "1"
#: guards the region and counter tables; taken only while tracing is on
_lock = threading.Lock()
_self_s: Dict[str, float] = defaultdict(float)
_counts: Dict[str, int] = defaultdict(int)
_ring: Deque[tuple] = deque(maxlen=RING_SIZE)     # RegionRecord fields
_local = threading.local()
_call_ids = itertools.count(1)


def enable(on: bool = True) -> None:
    """Turn the regions and counters on (or off again) without a
    profiler."""
    global _on
    _on = bool(on)


def active() -> bool:
    """Whether regions and counters record now."""
    return _on or _autograd_profiler._is_profiler_enabled


class _NoRegion:
    """The scope region() returns while tracing is off."""

    call = None

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NO_REGION = _NoRegion()


class _Region:
    """An active region. Its duration runs from the end of its entry to
    the start of its exit, so it leaves out its own bookkeeping and
    profiler annotation; the enclosing region's self time leaves out
    the whole scope, those included."""

    __slots__ = ("name", "call", "_parent", "_rf", "_scope0", "_t0",
                 "_child_ns")

    def __init__(self, name: str, call: Optional[int]):
        self.name = name
        self.call = call

    def __enter__(self):
        self._scope0 = time.perf_counter_ns()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = stack[-1] if stack else None
        self._parent = parent
        if self.call is None:
            self.call = (parent.call if parent is not None
                         else next(_call_ids))
        self._child_ns = 0
        self._rf = None
        if _autograd_profiler._is_profiler_enabled:
            self._rf = _autograd_profiler.record_function(self.name)
            self._rf.__enter__()
        stack.append(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        stack = _local.stack
        if stack and stack[-1] is self:
            stack.pop()
        else:
            stack.remove(self)
        if self._rf is not None:
            self._rf.__exit__(*exc)
        name, t0, parent = self.name, self._t0, self._parent
        dur_s = (t1 - t0) * 1e-9
        with _lock:
            s = _stats[name]
            s.count += 1
            s.total_s += dur_s
            if dur_s > s.max_s:
                s.max_s = dur_s
            _self_s[name] += dur_s - self._child_ns * 1e-9
            _ring.append((name, t0, t1, parent and parent.name, self.call))
        if parent is not None:
            parent._child_ns += time.perf_counter_ns() - self._scope0
        return False


def region(name: str, call: Optional[int] = None):
    """The hot path's timed scope (see the module docstring). `call`
    gives a root region the call id of an earlier one (the scope's
    `.call`), so the halves of one operation share it."""
    if not (_on or _autograd_profiler._is_profiler_enabled):
        return _NO_REGION
    return _Region(name, call)


def elapsed(name: str, start_ns: int) -> None:
    """Record a region that began at start_ns (time.perf_counter_ns())
    and ends now, such as a wait in a queue, while tracing is active. It
    has no parent and is not in the profiler's trace."""
    if not (_on or _autograd_profiler._is_profiler_enabled):
        return
    t1 = time.perf_counter_ns()
    dur = (t1 - start_ns) * 1e-9
    with _lock:
        s = _stats[name]
        s.count += 1
        s.total_s += dur
        s.max_s = max(s.max_s, dur)
        _self_s[name] += dur
        _ring.append((name, start_ns, t1, None, next(_call_ids)))


def count(name: str, n: int = 1) -> None:
    """Add n to counter `name` while tracing is active."""
    if _on or _autograd_profiler._is_profiler_enabled:
        with _lock:
            _counts[name] += n


def counters() -> Dict[str, int]:
    with _lock:
        return dict(_counts)


def self_times() -> Dict[str, float]:
    """Seconds each region spent outside the regions it enclosed."""
    with _lock:
        return dict(_self_s)


def regions() -> List[RegionRecord]:
    """The ring's records, the oldest first."""
    with _lock:
        return [RegionRecord(*r) for r in _ring]


def reset_counters() -> None:
    """Clear the counters, the self times and the ring (reset_stats()
    clears the span table)."""
    with _lock:
        _counts.clear()
        _self_s.clear()
        _ring.clear()
