"""Mean milliseconds a hybrid call spent in the program's region
hybrid.proximity: each anchor's hop depths (mirror.per_anchor) on the
host, while the vector leg runs on the device."""

from portbench import program_spans


def read(run):
    return program_spans.ms_per_call(run, "hybrid.proximity")
