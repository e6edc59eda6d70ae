"""The grade's share of its roofline: the least time for the frames
pushed in the profiled part (perfbench/roofline.py: each frame read and
written once, the table read once) over the device time of every
operation in that part."""

from perfbench import roofline


def read(rec):
    if rec.work.get("kind") != "grade" or not rec.trace \
            or not rec.trace_buffers:
        return None
    w = rec.work
    least = roofline.least_seconds(
        rec.trace_buffers * roofline.grade_bytes(w["frame_bytes"],
                                                 w["table_bytes"]))
    return roofline.share_pct(least, rec.trace["device_s"])
