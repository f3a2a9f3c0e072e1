"""Timed spans with aggregate stats.

Copy of cortex_tpu/utils/tracing.py: `span()` is a timed scope that
logs its duration and feeds a process-wide table (`stats()`,
`reset_stats()`), `timed` its decorator form. The auto-linker's cycle
runs its legs inside spans (linker.scan, linker.search, ...).
`profile_trace(log_dir)` is the reference's device-profile scope on
torch.profiler: the host's and, with CUDA, the card's activity, written
as a Chrome trace into log_dir.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterator

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
