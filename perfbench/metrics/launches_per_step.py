"""Kernel launches the profiler saw, over the steps pushed in the
profiled part (every operation of those steps is inside it)."""


def read(rec):
    if rec.work.get("kind") != "audio" or not rec.trace \
            or not rec.trace_buffers:
        return None
    return rec.trace["launches"] / rec.trace_buffers
