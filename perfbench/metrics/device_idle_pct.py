"""Share of the profiled part of the window in which no kernel, copy or
set ran on the card."""


def read(rec):
    return rec.idle_pct
