"""Host milliseconds a frame inside `push_buffer`, the schedulers'
`iterate` and `pull_all`, less the time inside the DeviceContext, outside
the profiled part."""


def read(rec):
    sp = rec.spans
    if "push" not in sp or not sp["push"][1]:
        return None
    host = sum(sp[k][0] for k in ("push", "iterate", "pull") if k in sp)
    host -= sp.get("context", (0.0, 0))[0]
    return host / sp["push"][1] * 1e3
