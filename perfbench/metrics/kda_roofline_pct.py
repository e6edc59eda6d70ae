"""The KDA kernel's share of its roofline: its least time for the fires
of the profiled part (perfbench/roofline_kimi_linear.py, from the
program's counters) over its device seconds there, summed by the
kernel's name from the profiler."""


def read(rec):
    w = rec.work
    if w.get("kind") != "llm" or not w.get("kda_device_s"):
        return None
    return 100.0 * w["kda_least_s"] / w["kda_device_s"]
