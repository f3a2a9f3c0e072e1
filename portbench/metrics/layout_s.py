"""Seconds of set-up in the program's span index.layout: the full builds of
the device layout: the flat upload with its host quantization, or the
IVF build."""

from portbench import program_spans


def read(run):
    return program_spans.span_s(run, "index.layout")
