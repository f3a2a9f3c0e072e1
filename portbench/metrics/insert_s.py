"""Seconds of set-up in the program's span index.insert: the corpus's
upsert_batch, the host's row assignment and mirror writes of
insert_batch."""

from portbench import program_spans


def read(run):
    return program_spans.span_s(run, "index.insert")
