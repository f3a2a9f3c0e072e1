"""What the per-layer metrics read from the program's own tracing tables
(cortex_tpu_torch/utils/tracing.py), in the process that ran the cell.

- The regions of the search path record only while a profiler traces,
  so they cover exactly the traced sub-window's calls. A region's mean
  per call is its total over the count of the root region
  search.dispatch, one a call (search.hits, for one, runs in more than
  one place of a call).
- The counters of the same calls are read per query, over
  search.queries.
- The index build's spans (index.insert, index.layout) record always:
  their totals are the set-up's.

A reading is None where there is nothing to read: a region or counter
that the cell's path does not run (the flat index re-ranks nothing on
the host), a program without such tables, or a traced window in which
nothing ran on a device (a run on the CPU measures no card, and reports
only the benchmark's own spans).
"""

from __future__ import annotations

from typing import Optional

CALLS = "search.dispatch"
QUERIES = "search.queries"


def _tables(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    try:
        from cortex_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing


def ms_per_call(run, region: str) -> Optional[float]:
    """Mean milliseconds a search call spent in `region`."""
    t = _tables(run)
    if t is None:
        return None
    st = t.stats()
    calls, s = st.get(CALLS), st.get(region)
    if calls is None or calls.count == 0 or s is None:
        return None
    return s.total_s / calls.count * 1e3


def per_query(run, counter: str) -> Optional[float]:
    """Counter `counter` over the queries of the same calls."""
    t = _tables(run)
    counters = getattr(t, "counters", None)
    if counters is None:
        return None
    c = counters()
    if counter not in c or not c.get(QUERIES):
        return None
    return c[counter] / c[QUERIES]


def span_s(run, name: str) -> Optional[float]:
    """Total seconds of the always-on span `name`."""
    t = _tables(run)
    if t is None:
        return None
    s = t.stats().get(name)
    return None if s is None else float(s.total_s)
