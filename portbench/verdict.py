"""The outcome of a run's comparison with its reference, in a form the
run loop reports whatever the system."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple


@dataclass
class Verdict:
    """The comparison's outcome: operations attempted and failed, each
    compared number as (value, "<=" or ">=", limit), the failed
    operations first, and values that metrics read (recall)."""

    attempted: int
    failed: int
    checks: Dict[str, Tuple[Optional[float], str, float]]
    values: Dict[str, float] = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return all(holds(*c) for c in self.checks.values())


def holds(value: Optional[float], op: str, limit: float) -> bool:
    """Whether a compared number keeps to its limit (a number that could
    not be read does not)."""
    return value is not None and (value <= limit if op == "<="
                                  else value >= limit)
