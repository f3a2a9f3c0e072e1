"""Rows within reach of an anchor, a hybrid query with anchors in the
traced sub-window: the program's counter hybrid.reached_rows (entries of
the proximity leg's depth map) over its counter hybrid.queries."""

from portbench import program_spans


def read(run):
    reached = program_spans.per_query(run, "hybrid.reached_rows")
    queries = program_spans.per_query(run, "hybrid.queries")
    if reached is None or not queries:
        return None
    return reached / queries
