"""`streams` pipelines `appsrc ! llamatexttransform model-path=<dir>
context=... ! appsink` in one DeviceContext, fed caption lines in a
closed loop.

The model directory holds only the configuration's config.json (under
build/ in the checkout), so the element runs the port's own deepseek_v3
model with weights drawn from the seed. Every element gets the same
`system_prompt_tokens`-byte system prompt, `history-size`, `max-tokens`
and temp=0. A round pushes one caption line, `media_s` of media, into
every pipeline's `appsrc` and runs each scheduler until it idles; the
context fires once every pipeline has submitted its prompt: one batched
prefill and decode of every stream. The round then pulls the replies. A
stream's next line waits for its reply, because its history holds it.

Lines: pipeline i at round k says a line of n bytes (= tokens), n drawn
log-normal around `line_tokens.median` with `sigma`, clipped to [min,
max], words of seeded letters; all from (seed, i, k).

The check: `check_requests` streams drawn from the seed keep their
replies' logits and chosen experts; their last replies of the run are
held against the plain reference's full forward pass over the prompt
and the generated ids, routed to the experts the program chose
(`logit_rel_rms`, `logit_max_gap`), and the program's choices against
the reference's own scores (`route_gap`). The reference takes the
program's discrete choices, ids and experts, because with random
weights both flip on rounding: two experts' scores tie within bf16's
rounding at a few percent of tokens a layer, and one flipped expert
moves a position's logits by tens of percent, in a bf16 program and in
one a precision below alike. The traced run installs the
program's `program-spans` tracer with device intervals over the
profiled part: the per-layer readers take the fires' prefill and decode
device times, wall times and counters from it.

Set-up fails with the element's message where a pipeline does not
start, as on a tree whose llamatexttransform cannot load a config-only
directory.
"""

from __future__ import annotations

import json
import math
import random
from pathlib import Path

import numpy as np
import torch

from perfbench import roofline_llm
from perfbench.harness import Record
from perfbench.timing import Spans, now, phase
from perfbench.window import Window

CONTEXT = "perfbench-llm"
ROOT = Path(__file__).resolve().parents[2]
# keys of a configuration file that are the benchmark's, not the model's
BENCH_KEYS = ("name", "reference", "source", "reduced", "deployment",
              "assumed", "limits")
SECOND = 1_000_000_000


def model_config(cfg: dict) -> dict:
    return {k: v for k, v in cfg.items() if k not in BENCH_KEYS}


def model_dir(cfg: dict) -> str:
    """A directory under build/ holding only the model's config.json."""
    d = ROOT / "build" / "perfbench-llm" / cfg["name"]
    d.mkdir(parents=True, exist_ok=True)
    (d / "config.json").write_text(json.dumps(model_config(cfg)))
    return str(d)


def system_prompt(n: int) -> str:
    """The same n-byte instruction for every stream and seed."""
    text = ("You rewrite live subtitles for broadcast: keep the meaning, "
            "fix the grammar, keep names and numbers, and answer with the "
            "rewritten line only. ")
    return (text * (n // len(text) + 1))[:n - 1] + "."


def caption(seed: int, stream: int, k: int, spec: dict) -> str:
    """Stream `stream`'s line at round k: lowercase words, n bytes."""
    rng = np.random.default_rng([seed % 2 ** 63, stream, k])
    n = int(np.clip(round(math.exp(math.log(spec["median"])
                                   + spec["sigma"] * rng.standard_normal())),
                    spec["min"], spec["max"]))
    letters = rng.integers(97, 123, n)
    spaces = rng.random(n) < 0.18
    spaces[0] = spaces[-1] = False
    return bytes(np.where(spaces, 32, letters).astype(np.uint8)).decode()


def launch_string(cfg: dict, tr: dict, path: str, seed: int) -> str:
    return ('appsrc name=src caps="text/x-raw, format=utf8" ! '
            f'llamatexttransform name=lm model-path={path} '
            f'context={CONTEXT} temp=0 seed={seed % 2 ** 63} '
            f'max-tokens={tr["max_tokens"]} '
            f'history-size={tr["history_size"]} ! appsink name=sink')


def checked_streams(cell) -> list:
    tr = cell.traffic
    return sorted(random.Random(cell.seed).sample(
        range(tr["streams"]), min(tr["check_requests"], tr["streams"])))


def _started(p) -> None:
    """Raise with an element's error message, where one was posted."""
    err = p._error_seen
    if err is not None:
        raise RuntimeError(f"a pipeline failed: {err.fields.get('text')}")


def run(cell) -> Record:
    import gstpu_torch
    from gstpu_torch.runtime.device_batch import DeviceContext
    from gstpu_torch.utils import tracing

    cfg, tr, dev = cell.config, cell.traffic, torch.device(cell.device)
    S, dur = tr["streams"], round(tr["media_s"] * SECOND)
    gstpu_torch.init(device=dev)
    phase("program imported")
    path = model_dir(cfg)
    DeviceContext.release(CONTEXT)
    pipes = [gstpu_torch.parse_launch(launch_string(cfg, tr, path,
                                                    cell.seed))
             for _ in range(S)]
    lms = [p.get_by_name("lm") for p in pipes]
    keep = checked_streams(cell)
    prompt = system_prompt(tr["system_prompt_tokens"])
    for i, lm in enumerate(lms):
        lm.system_prompt = prompt
        lm.keep_logits = i in keep
    for p in pipes:
        p.set_state(gstpu_torch.State.PLAYING)
        _started(p)
    srcs = [p.get_by_name("src") for p in pipes]
    sinks = [p.get_by_name("sink") for p in pipes]
    model = lms[0]._lm.model
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    phase("pipelines and model")

    spans = Spans(enabled=cell.trace)
    failed = 0

    def one_round(k: int, win: Window | None) -> None:
        nonlocal failed
        pushes = []
        for i, p in enumerate(pipes):
            line = caption(cell.seed, i, k, tr["line_tokens"]).encode()
            t = now()
            with spans.span("push"):
                srcs[i].push_buffer(gstpu_torch.Buffer(
                    line, pts=k * dur, duration=dur))
            with spans.span("iterate"):
                while p.iterate():
                    pass
            pushes.append(t)
        with spans.span("pull"):
            for i, p in enumerate(pipes):
                _started(p)
                bufs = sinks[i].pull_all()
                if len(bufs) != 1 or bufs[0].pts != k * dur:
                    failed += 1
        if win is not None:
            win.pushed(pushes, win.clock.mark())

    k = 0
    for k in range(tr["warm_rounds"]):
        one_round(k, None)
    rec = Record(streams=S, media_s=tr["media_s"], window=(0.0, 0.0))
    win = Window(cell, rec, spans, tr["in_flight"])
    prog = None
    if win.tracer is not None:
        prog = tracing.ProgramSpans(device=True)
        prog.install()
        prog.keep(True)
    spans.seconds.clear()
    spans.calls.clear()
    win.open()
    while win.running():
        if prog is not None and rec.traced is not None:
            rec.work = traced_fires(cfg, prog, rec.traced)
            prog = None
        k += 1
        one_round(k, win)
    win.close()
    if prog is not None:
        rec.work = traced_fires(cfg, prog, rec.traced)
    rec.failed = failed
    rec.state = dict(model=model, kept=[lms[i].last_reply for i in keep])
    for p in pipes:
        p.set_state(gstpu_torch.State.NULL)
    DeviceContext.release(CONTEXT)
    return rec


def traced_fires(cfg: dict, prog, traced: tuple) -> dict:
    """What the program's tracer saw of the fires inside the profiled
    part `traced` (host seconds): their wall seconds, the device ms of
    each prefill and decode step, the counters and the model FLOPs. It
    uninstalls the tracer."""
    prog.keep(False)
    prog.uninstall()
    a, b = traced[0] * 1e9, traced[1] * 1e9
    fires = {r: (e - s) * 1e-9 for s, e, n, _, _, r, _ in prog.intervals()
             if n == "llm.fire" and a <= s and e <= b}
    dev = prog.device_intervals()
    c = prog.snapshot()["counters"]
    return dict(
        kind="llm", fires=len(fires), fire_s=sum(fires.values()),
        prefill_ms=[(e - s) * 1e-6 for s, e, n, _, r in dev
                    if n == "llm.prefill" and r in fires],
        decode_ms=[(e - s) * 1e-6 for s, e, n, _, r in dev
                   if n == "llm.decode" and r in fires],
        counters=c,
        flops=roofline_llm.model_flops(
            model_config(cfg), c.get("llm.requests", 0),
            c.get("llm.prefill_tokens", 0), c.get("llm.decode_tokens", 0),
            c.get("llm.attn_keys", 0)))


def logit_gaps(model, replies: list, ref) -> dict:
    """The comparison's numbers for the replies: the largest over
    positions of |program - reference| / |reference| over the vocabulary
    (`logit_rel_rms`), the largest |program - reference| (`logit_max_gap`),
    for the logits at every generated position against the reference's
    full forward pass over each prompt and its generated ids on the
    program's experts, and the reference's `route_gap` of those
    experts."""
    weights = model.state_dict()
    rel = gap = 0.0
    stats = {}
    for r in replies:
        ids = np.concatenate([r.prompt_ids, np.asarray(r.ids[:-1])])
        if r.routes is None or r.routes.shape[1] != ids.size \
                or r.logits is None or r.logits.shape[0] != len(r.ids):
            return dict.fromkeys(("logit_rel_rms", "logit_max_gap",
                                  "route_gap"), math.inf)
        want = ref.forward(model.config, weights, torch.from_numpy(
            ids.astype(np.int64)), routes=r.routes,
            stats=stats)[len(r.prompt_ids) - 1:]
        d = r.logits.float() - want
        rel = max(rel, float((d.norm(dim=-1) / want.norm(dim=-1)).max()))
        gap = max(gap, float(d.abs().max()))
    return {"logit_rel_rms": rel, "logit_max_gap": gap,
            "route_gap": stats.get("route_gap", 0.0)}


def check(cell, rec: Record) -> None:
    lim = cell.config["limits"]
    kept = [r for r in rec.state["kept"] if r is not None]
    got = logit_gaps(rec.state["model"], kept, cell.reference) if kept \
        else dict.fromkeys(lim, float("inf"))
    rec.checks = {k: (got[k], float(v)) for k, v in lim.items()}
    rec.state.clear()


def check_prompts(cell) -> list:
    """`check_requests` prompts shaped like the window's: the system
    prompt, `history_size` exchanges of drawn lines and max-tokens-byte
    replies, and a line, as llamatexttransform lays them out."""
    tr = cell.traffic
    rng = np.random.default_rng([cell.seed % 2 ** 63, 1])
    out = []
    for i in checked_streams(cell):
        parts = [system_prompt(tr["system_prompt_tokens"])]
        for k in range(tr["history_size"]):
            reply = bytes(rng.integers(32, 127, tr["max_tokens"],
                                       dtype=np.uint8)).decode()
            parts.append(f"User: {caption(cell.seed, i, k, tr['line_tokens'])}"
                         f"\nAssistant: {reply}")
        parts.append(f"User: {caption(cell.seed, i, 99, tr['line_tokens'])}"
                     "\nAssistant:")
        out.append(np.frombuffer("\n".join(parts).encode(), np.uint8))
    return out


def readings(cell) -> tuple:
    """The comparison's numbers on `check_prompts`, each in one fire of
    one model drawn from the seed: (the program's, the control's). The
    control rounds every routed expert weight to fp8 e4m3 (one precision
    below the config's bf16) for its fire; the reference keeps the
    weights as drawn."""
    from gstpu_torch.elements.text.llm import LmReply
    from gstpu_torch.models.deepseek_v3 import DeepseekV3Lm
    model = DeepseekV3Lm.from_seed(model_config(cell.config),
                                   cell.seed % 2 ** 63, cell.device)
    prompts = check_prompts(cell)
    experts = [lw for lw in model.p["layers"] if "w13" in lw]

    def fire():
        gen = model.generate(prompts, cell.traffic["max_tokens"],
                             keep=range(len(prompts)))
        return [LmReply("", p, ids, gen.logits[i], gen.routes[i])
                for i, (p, ids) in enumerate(zip(prompts, gen.ids))]

    program = fire()
    drawn = [(lw["w13"], lw["w2"]) for lw in experts]
    for lw in experts:
        lw["w13"], lw["w2"] = (w.to(torch.float8_e4m3fn).to(w.dtype)
                               for w in (lw["w13"], lw["w2"]))
    control = fire()
    for lw, (w13, w2) in zip(experts, drawn):
        lw["w13"], lw["w2"] = w13, w2
    return (logit_gaps(model, program, cell.reference),
            logit_gaps(model, control, cell.reference))


def control(cell) -> dict:
    return readings(cell)[1]
