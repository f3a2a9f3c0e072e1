"""Device selection, timed spans and the profiler scope."""

from .tracing import (SpanStats, profile_trace, reset_stats, span, stats,
                      timed)

__all__ = ["SpanStats", "profile_trace", "reset_stats", "span", "stats",
           "timed"]
