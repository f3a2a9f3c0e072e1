"""Prometheus metrics registry (text exposition format, no external deps).

Parity: cortex-server/src/http/metrics.rs:38-82 — node/edge gauges by
kind/relation, db size, linker counters/gauges/histogram, gate outcomes
by check, search count + duration by endpoint, http request counters by
method/status, uptime. Linker metrics are mirrored each cycle
(serve.rs:202-218).
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Dict, List, Tuple

from ..utils import tracing

_BUCKETS = [0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
            5.0, 10.0]


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class CortexMetrics:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, Tuple], float] = defaultdict(float)
        self._gauges: Dict[Tuple[str, Tuple], float] = {}
        self._hist: Dict[Tuple[str, Tuple], List[float]] = defaultdict(
            lambda: [0.0] * (len(_BUCKETS) + 1))
        self._hist_sum: Dict[Tuple[str, Tuple], float] = defaultdict(float)
        self._hist_count: Dict[Tuple[str, Tuple], float] = defaultdict(float)
        self._help: Dict[str, str] = {}
        self._types: Dict[str, str] = {}
        self.started_at = time.time()

    def _key(self, name: str, labels: Dict[str, str]) -> Tuple[str, Tuple]:
        return name, tuple(sorted(labels.items()))

    def describe(self, name: str, help_text: str, mtype: str) -> None:
        self._help[name] = help_text
        self._types[name] = mtype

    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        with self._lock:
            self._types.setdefault(name, "counter")
            self._counters[self._key(name, labels)] += value

    def set_gauge(self, name: str, value: float, **labels) -> None:
        with self._lock:
            self._types.setdefault(name, "gauge")
            self._gauges[self._key(name, labels)] = value

    def observe(self, name: str, value: float, **labels) -> None:
        with self._lock:
            self._types.setdefault(name, "histogram")
            key = self._key(name, labels)
            buckets = self._hist[key]
            for i, ub in enumerate(_BUCKETS):
                if value <= ub:
                    buckets[i] += 1
            buckets[-1] += 1    # +Inf
            self._hist_sum[key] += value
            self._hist_count[key] += 1

    # ----------------------------------------------------------- rendering
    def render(self) -> str:
        with self._lock:
            out: List[str] = []
            self.set_gauge_unlocked("cortex_uptime_seconds",
                                    time.time() - self.started_at)
            if tracing.active():
                self._mirror_tracing_unlocked()
            names = sorted({n for n, _ in list(self._counters)
                            + list(self._gauges) + list(self._hist)})
            for name in names:
                if name in self._help:
                    out.append(f"# HELP {name} {self._help[name]}")
                out.append(f"# TYPE {name} {self._types.get(name, 'gauge')}")
                for (n, lbl), v in sorted(self._counters.items()):
                    if n == name:
                        out.append(f"{name}{_fmt_labels(dict(lbl))} {v}")
                for (n, lbl), v in sorted(self._gauges.items()):
                    if n == name:
                        out.append(f"{name}{_fmt_labels(dict(lbl))} {v}")
                for (n, lbl), buckets in sorted(self._hist.items()):
                    if n != name:
                        continue
                    base = dict(lbl)
                    for i, ub in enumerate(_BUCKETS):
                        out.append(
                            f"{name}_bucket"
                            f"{_fmt_labels({**base, 'le': str(ub)})} "
                            f"{buckets[i]}")
                    out.append(
                        f"{name}_bucket{_fmt_labels({**base, 'le': '+Inf'})} "
                        f"{buckets[-1]}")
                    out.append(f"{name}_sum{_fmt_labels(base)} "
                               f"{self._hist_sum[(n, lbl)]}")
                    out.append(f"{name}_count{_fmt_labels(base)} "
                               f"{self._hist_count[(n, lbl)]}")
            return "\n".join(out) + "\n"

    def set_gauge_unlocked(self, name: str, value: float, **labels) -> None:
        self._types.setdefault(name, "gauge")
        self._gauges[self._key(name, labels)] = value

    def _mirror_tracing_unlocked(self) -> None:
        """The process's span table and trace counters
        (utils/tracing.py), rendered while tracing is active."""
        for span_name, st in tracing.stats().items():
            for name, value in (("cortex_span_seconds_total", st.total_s),
                                ("cortex_span_calls_total", st.count)):
                self._types.setdefault(name, "counter")
                self._counters[self._key(name, {"span": span_name})] = value
        for counter, n in tracing.counters().items():
            self._types.setdefault("cortex_trace_count_total", "counter")
            self._counters[self._key("cortex_trace_count_total",
                                     {"name": counter})] = n

    # ------------------------------------------------------------- mirrors
    def mirror_storage(self, stats) -> None:
        self.set_gauge("cortex_nodes_total", stats.node_count)
        self.set_gauge("cortex_edges_total", stats.edge_count)
        self.set_gauge("cortex_deleted_nodes_total",
                       stats.deleted_node_count)
        self.set_gauge("cortex_db_size_bytes", stats.db_size_bytes)
        for kind, n in stats.nodes_by_kind.items():
            self.set_gauge("cortex_nodes_by_kind", n, kind=kind)
        for rel, n in stats.edges_by_relation.items():
            self.set_gauge("cortex_edges_by_relation", n, relation=rel)

    def mirror_linker(self, m) -> None:
        self.set_gauge("cortex_linker_cycles_completed", m.cycles_completed)
        self.set_gauge("cortex_linker_nodes_processed_total",
                       m.nodes_processed)
        self.set_gauge("cortex_linker_edges_created_total", m.edges_created)
        self.set_gauge("cortex_linker_edges_pruned_total", m.edges_pruned)
        self.set_gauge("cortex_linker_edges_deleted_total", m.edges_deleted)
        self.set_gauge("cortex_linker_duplicates_found_total",
                       m.duplicates_found)
        self.set_gauge("cortex_linker_contradictions_found_total",
                       m.contradictions_found)
        self.set_gauge("cortex_linker_backlog_size", m.backlog_size)
        self.observe("cortex_linker_cycle_duration_seconds",
                     m.cycle_duration_secs)

    def record_gate(self, outcome: str, check: str = "") -> None:
        if outcome == "pass":
            self.inc("cortex_gate_pass_total")
        elif outcome == "skip":
            self.inc("cortex_gate_skip_total")
        else:
            self.inc("cortex_gate_reject_total", check=check)

    def record_search(self, endpoint: str, duration_secs: float) -> None:
        self.inc("cortex_search_requests_total", endpoint=endpoint)
        self.observe("cortex_search_duration_seconds", duration_secs,
                     endpoint=endpoint)

    def record_http(self, method: str, status: int) -> None:
        self.inc("cortex_http_requests_total", method=method,
                 status=str(status))
