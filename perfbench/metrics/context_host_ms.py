"""Host milliseconds a fire inside the DeviceContext (`submit`, `_fire`,
`_distribute`, outermost call only), outside the profiled part."""


def read(rec):
    fires = rec.counts.get("fires", 0)
    if not fires or "context" not in rec.spans:
        return None
    return rec.spans["context"][0] / fires * 1e3
