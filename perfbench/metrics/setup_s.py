"""Seconds from process start to the first timed buffer: imports,
registration, kernel builds, inputs, priming and warm-up."""


def read(rec):
    return rec.setup_s
