"""Auto-linker metrics: per-cycle + cumulative counters + summary line.

Parity: crates/cortex-core/src/linker/metrics.rs:7-163. Mirrored into the
Prometheus registry by the server each cycle (serve.rs:202-218 analog).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict


@dataclass
class LinkerMetrics:
    # per-cycle
    cycle_nodes_processed: int = 0
    cycle_edges_created: int = 0
    cycle_edges_pruned: int = 0
    cycle_edges_deleted: int = 0
    cycle_duplicates_found: int = 0
    cycle_contradictions_found: int = 0
    cycle_duration_secs: float = 0.0
    # cumulative
    cycles_completed: int = 0
    nodes_processed: int = 0
    edges_created: int = 0
    edges_pruned: int = 0
    edges_deleted: int = 0
    duplicates_found: int = 0
    contradictions_found: int = 0
    # gauges
    backlog_size: int = 0
    total_nodes: int = 0
    total_edges: int = 0
    cursor: float = 0.0

    def reset_cycle(self) -> None:
        self.cycle_nodes_processed = 0
        self.cycle_edges_created = 0
        self.cycle_edges_pruned = 0
        self.cycle_edges_deleted = 0
        self.cycle_duplicates_found = 0
        self.cycle_contradictions_found = 0
        self.cycle_duration_secs = 0.0

    def add_nodes_processed(self, n: int) -> None:
        self.cycle_nodes_processed += n
        self.nodes_processed += n

    def add_edges_created(self, n: int) -> None:
        self.cycle_edges_created += n
        self.edges_created += n

    def add_edges_pruned(self, n: int) -> None:
        self.cycle_edges_pruned += n
        self.edges_pruned += n

    def add_edges_deleted(self, n: int) -> None:
        self.cycle_edges_deleted += n
        self.edges_deleted += n

    def add_duplicates_found(self, n: int) -> None:
        self.cycle_duplicates_found += n
        self.duplicates_found += n

    def add_contradictions_found(self, n: int) -> None:
        self.cycle_contradictions_found += n
        self.contradictions_found += n

    def summary(self) -> str:
        return (f"linker cycle {self.cycles_completed}: "
                f"processed={self.cycle_nodes_processed} "
                f"created={self.cycle_edges_created} "
                f"pruned={self.cycle_edges_pruned} "
                f"deleted={self.cycle_edges_deleted} "
                f"dups={self.cycle_duplicates_found} "
                f"contradictions={self.cycle_contradictions_found} "
                f"backlog={self.backlog_size} "
                f"totals(n={self.total_nodes},e={self.total_edges}) "
                f"took={self.cycle_duration_secs * 1000:.1f}ms")

    def to_dict(self) -> Dict[str, float]:
        return {k: getattr(self, k) for k in self.__dataclass_fields__}
