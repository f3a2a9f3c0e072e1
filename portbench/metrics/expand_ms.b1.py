"""Mean host time a search call spent in the program's region search.expand
in the traced sub-window, in ms: the kNN graph's widening of the IVF
candidates."""

from portbench import program_spans


def read(run):
    return program_spans.ms_per_call(run, "search.expand")
