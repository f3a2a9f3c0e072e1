"""Device selection and timed spans."""

from .tracing import SpanStats, reset_stats, span, stats, timed

__all__ = ["SpanStats", "reset_stats", "span", "stats", "timed"]
