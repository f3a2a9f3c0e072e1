"""Mean host time a search call spent in the program's region search.fetch
in the traced sub-window, in ms: the copy of the candidates' values and
rows to the host, which waits for the device."""

from portbench import program_spans


def read(run):
    return program_spans.ms_per_call(run, "search.fetch")
