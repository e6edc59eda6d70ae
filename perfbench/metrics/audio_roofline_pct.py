"""The flagship step's share of its roofline: the least time for the
steps pushed in the profiled part (perfbench/roofline.py: samples in and
out, echo and look-ahead state, each once; f64 operations) over the
device time of every operation in that part."""

from perfbench import roofline


def read(rec):
    if rec.work.get("kind") != "audio" or not rec.trace \
            or not rec.trace_buffers:
        return None
    w = rec.work
    n = rec.trace_buffers
    least = roofline.least_seconds(
        n * roofline.audio_bytes(w["lanes"], w["samples"]),
        n * w["lanes"] * w["samples"] * roofline.AUDIO_OPS_PER_SAMPLE)
    return roofline.share_pct(least, rec.trace["device_s"])
