"""Rows a query in the traced sub-window: the program's counter
search.rerank_rows, the valid candidate rows the host re-ranked, over
its counter search.queries."""

from portbench import program_spans


def read(run):
    return program_spans.per_query(run, "search.rerank_rows")
