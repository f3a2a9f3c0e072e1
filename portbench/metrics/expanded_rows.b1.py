"""Rows a query in the traced sub-window: the program's counter
search.expanded_rows, the valid rows the kNN graph added to the
candidates, after the dedup, over its counter search.queries."""

from portbench import program_spans


def read(run):
    return program_spans.per_query(run, "search.expanded_rows")
