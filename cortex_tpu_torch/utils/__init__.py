"""Device selection, timed spans, the hot path's regions and counters,
and the profiler scope."""

from .tracing import (SpanStats, active, count, counters, enable,
                      profile_trace, region, regions, reset_counters,
                      reset_stats, self_times, span, stats, timed)

__all__ = ["SpanStats", "active", "count", "counters", "enable",
           "profile_trace", "region", "regions", "reset_counters",
           "reset_stats", "self_times", "span", "stats", "timed"]
