"""The fires' model FLOPs (perfbench/roofline_llm.py, from the program's
counters over the profiled part) over their wall time in `llm.fire`
times the card's dense bf16 peak."""

from perfbench import roofline_llm


def read(rec):
    w = rec.work
    if w.get("kind") != "llm" or not w.get("fires") or w["fire_s"] <= 0:
        return None
    return 100.0 * w["flops"] / (w["fire_s"] * roofline_llm.BF16_FLOPS_PER_S)
