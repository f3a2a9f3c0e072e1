"""Mean host time a search call spent in the program's region
search.prepare in the traced sub-window, in ms: host work before any
launch: the queries' normalization, the corpus's sync, the filter codes
and the k bucket."""

from portbench import program_spans


def read(run):
    return program_spans.ms_per_call(run, "search.prepare")
