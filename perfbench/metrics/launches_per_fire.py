"""Kernel launches the profiler saw, over the LLM fires of the profiled
part (every operation of those fires is inside it)."""


def read(rec):
    w = rec.work
    if w.get("kind") != "llm" or not w.get("fires") or not rec.trace:
        return None
    return rec.trace["launches"] / w["fires"]
