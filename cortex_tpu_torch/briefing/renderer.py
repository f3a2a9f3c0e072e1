"""Briefing renderers: markdown + compact (~4x denser).

Parity: crates/cortex-core/src/briefing/renderer.rs:4-110 — char-budget
truncation with " [truncated]" marker, 200-char body previews with "...".
Python strings are already unicode-safe, matching the reference's
char-boundary care.
"""

from __future__ import annotations

from datetime import datetime, timezone
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from .engine import Briefing, BriefingSection

_SUFFIX = " [truncated]"


def truncate(s: str, max_chars: int) -> str:
    if len(s) <= max_chars:
        return s
    if max_chars > len(_SUFFIX):
        return s[:max_chars - len(_SUFFIX)] + _SUFFIX
    return s[:max_chars]


def body_preview(s: str, max_chars: int = 200) -> str:
    if len(s) <= max_chars:
        return s
    return s[:max(max_chars - 3, 0)] + "..."


class MarkdownRenderer:
    def __init__(self, max_chars: int = 8000):
        self.max_chars = max_chars

    def render(self, briefing: "Briefing") -> str:
        ts = datetime.fromtimestamp(briefing.generated_at, timezone.utc)
        out = (f"# Briefing: {briefing.agent_id}\n"
               f"_Generated: {ts.strftime('%Y-%m-%d %H:%M UTC')}_\n\n")
        for section in briefing.sections:
            out += f"## {section.title}\n\n"
            for node in section.nodes:
                out += f"- **{node.title}**: {body_preview(node.body)}\n"
            out += "\n"
        return truncate(out, self.max_chars)


class CompactRenderer:
    def __init__(self, max_chars: int = 8000):
        self.max_chars = max_chars

    def render(self, briefing: "Briefing") -> str:
        out = f"# {briefing.agent_id}\n"
        for section in briefing.sections:
            out += f"## {section.title}\n"
            for node in section.nodes:
                out += f"- {node.title}\n"
        return truncate(out, self.max_chars)
