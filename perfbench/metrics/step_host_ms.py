"""Host milliseconds inside one call of the chain's step, outside the
profiled part: the enqueue of ~3,000 operations and the limiter's waits
on the device."""


def read(rec):
    s = rec.spans.get("step")
    if not s or not s[1]:
        return None
    return s[0] / s[1] * 1e3
