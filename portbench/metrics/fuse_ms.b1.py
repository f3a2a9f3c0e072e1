"""Mean milliseconds a hybrid call spent in the program's region
hybrid.fuse: after the vector hits are on the host, each hit's node
hydrated, scored with its graph score, and the sort."""

from portbench import program_spans


def read(run):
    return program_spans.ms_per_call(run, "hybrid.fuse")
