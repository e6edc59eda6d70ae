"""Device milliseconds a fire in `llm.prefill` (the batched prefill of
every stream's prompt into the latent cache), over the fires of the
profiled part, from the program's device intervals."""


def read(rec):
    ms = rec.work.get("prefill_ms") if rec.work.get("kind") == "llm" \
        else None
    if not ms:
        return None
    return sum(ms) / len(ms)
