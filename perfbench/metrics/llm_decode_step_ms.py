"""Device milliseconds a decode step in `llm.decode` (one token of every
stream through the latent cache), over the decode steps of the fires of
the profiled part, from the program's device intervals."""


def read(rec):
    ms = rec.work.get("decode_ms") if rec.work.get("kind") == "llm" \
        else None
    if not ms:
        return None
    return sum(ms) / len(ms)
