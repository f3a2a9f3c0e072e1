"""Mean host time a search call spent in the program's region search.rerank
in the traced sub-window, in ms: the exact re-rank of the candidates
against the host's fp32 rows."""

from portbench import program_spans


def read(run):
    return program_spans.ms_per_call(run, "search.rerank")
