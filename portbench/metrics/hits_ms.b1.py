"""Mean host time a search call spent in the program's region search.hits
in the traced sub-window, in ms: the host finish after the copy: the
masks and the id map of _finish_topk, and the hit lists of the index
entry."""

from portbench import program_spans


def read(run):
    return program_spans.ms_per_call(run, "search.hits")
