"""Mean host time a search call spent in the program's region search.launch
in the traced sub-window, in ms: each _dispatch_search: the queries'
upload, the bias and the kernels enqueued (IVF: the centroid product,
the probe top-k, probed_scores, the top candidates and their dedup)."""

from portbench import program_spans


def read(run):
    return program_spans.ms_per_call(run, "search.launch")
