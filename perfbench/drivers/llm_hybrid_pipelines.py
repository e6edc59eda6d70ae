"""`streams` pipelines `appsrc ! llamatexttransform model-path=<dir>
context=... ! appsink` in one DeviceContext, fed caption lines in a
closed loop, for a model of linear and full attention layers
(`kimi_linear`).

The traffic, the pipelines and the round are llm_pipelines' (its module
docstring says how): the same launch string, lines, system prompt,
checked streams and comparison of the kept replies' logits with the
plain reference, which takes the program's ids and experts. The check
adds `expert_rel_rms`, the routed experts alone at the window's last
decode step (`expert_gap`), which the logits cannot part from a lower
precision of the experts where this card holds a quarter of them. This
driver has its own loop for what the traced run reads: the fires' model
FLOPs from roofline_kimi_linear.py (the program's counters, with the
KDA layers' tokens), and the KDA kernel's device seconds, summed by its
name over the profiler's operations in the profiled part before the
window reduces them.

Set-up fails with the element's message where a pipeline does not
start, as on a tree whose llamatexttransform cannot load a config-only
kimi_linear directory.
"""

from __future__ import annotations

import math

import torch

from perfbench import roofline_kimi_linear as roofline
from perfbench.drivers import llm_pipelines as llm
from perfbench.harness import Record
from perfbench.timing import Spans, _device_ops, now, phase
from perfbench.window import Window

KDA_KERNEL = "kda_kernel"      # kernels/kda.cu's kernel, in its name


def run(cell) -> Record:
    import gstpu_torch
    from gstpu_torch.runtime.device_batch import DeviceContext
    from gstpu_torch.utils import tracing

    cfg, tr, dev = cell.config, cell.traffic, torch.device(cell.device)
    S, dur = tr["streams"], round(tr["media_s"] * llm.SECOND)
    gstpu_torch.init(device=dev)
    phase("program imported")
    path = llm.model_dir(cfg)
    DeviceContext.release(llm.CONTEXT)
    pipes = [gstpu_torch.parse_launch(llm.launch_string(cfg, tr, path,
                                                        cell.seed))
             for _ in range(S)]
    lms = [p.get_by_name("lm") for p in pipes]
    keep = llm.checked_streams(cell)
    prompt = llm.system_prompt(tr["system_prompt_tokens"])
    for i, lm in enumerate(lms):
        lm.system_prompt = prompt
        lm.keep_logits = i in keep
    for p in pipes:
        p.set_state(gstpu_torch.State.PLAYING)
        llm._started(p)
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
            line = llm.caption(cell.seed, i, k, tr["line_tokens"]).encode()
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
                llm._started(p)
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
            rec.work = traced_fires(cfg, prog, rec.traced, win.tracer.prof)
            prog = None
        k += 1
        one_round(k, win)
    win.close()
    if prog is not None:
        rec.work = traced_fires(cfg, prog, rec.traced, None)
    rec.failed = failed
    rec.state = dict(model=model, kept=[lms[i].last_reply for i in keep])
    for p in pipes:
        p.set_state(gstpu_torch.State.NULL)
    DeviceContext.release(llm.CONTEXT)
    return rec


def traced_fires(cfg: dict, prog, traced: tuple, prof) -> dict:
    """What the program's tracer saw of the fires inside the profiled
    part `traced` (host seconds), as llm_pipelines.traced_fires reads
    it, with this model's FLOPs; and from the profiler `prof` (None once
    reduced) the KDA kernel's device seconds and least time. It
    uninstalls the tracer."""
    prog.keep(False)
    prog.uninstall()
    a, b = traced[0] * 1e9, traced[1] * 1e9
    fires = {r: (e - s) * 1e-9 for s, e, n, _, _, r, _ in prog.intervals()
             if n == "llm.fire" and a <= s and e <= b}
    dev = prog.device_intervals()
    c = prog.snapshot()["counters"]
    work = dict(
        kind="llm", fires=len(fires), fire_s=sum(fires.values()),
        prefill_ms=[(e - s) * 1e-6 for s, e, n, _, r in dev
                    if n == "llm.prefill" and r in fires],
        decode_ms=[(e - s) * 1e-6 for s, e, n, _, r in dev
                   if n == "llm.decode" and r in fires],
        counters=c, flops=roofline.model_flops(llm.model_config(cfg), c))
    if prof is not None:
        work["kda_device_s"] = sum(
            (e - s) * 1e-6 for n, s, e in _device_ops(prof)
            if KDA_KERNEL in n)
        work["kda_least_s"] = roofline.kda_least_seconds(cfg, c)
    return work


def expert_gap(model, ref) -> float:
    """The routed experts alone, on the timed path: the largest over
    expert layers of |program - reference| / |reference| (norms over
    every row and the hidden width) of the routed experts' weighted sum
    at the model's last decode step (`KimiLinearLm.tap`), the reference
    given the program's input to the layer and its experts; inf where no
    layer's reference is nonzero (no decode step ran)."""
    if getattr(model, "tap", None) is None:
        return math.inf
    moe, routes = model.tap
    weights, gaps = model.state_dict(), []
    for i in range(model.shape.dense_layers, model.shape.layers):
        want = ref.routed(model.config, weights, i, moe[i, 0], routes[i])
        if float(want.norm()) > 0.0:
            gaps.append(float((moe[i, 1].float() - want).norm()
                              / want.norm()))
    return max(gaps, default=math.inf)


def numbers(model, replies: list, ref) -> dict:
    """The comparison's numbers: llm_pipelines.logit_gaps' of the kept
    replies and `expert_gap`'s `expert_rel_rms`."""
    got = llm.logit_gaps(model, replies, ref) if replies else \
        dict.fromkeys(("logit_rel_rms", "logit_max_gap", "route_gap"),
                      math.inf)
    got["expert_rel_rms"] = expert_gap(model, ref)
    return got


def check(cell, rec: Record) -> None:
    lim = cell.config["limits"]
    got = numbers(rec.state["model"],
                  [r for r in rec.state["kept"] if r is not None],
                  cell.reference)
    rec.checks = {k: (got[k], float(v)) for k, v in lim.items()}
    rec.state.clear()


def _bf16_state(q, k, v, g, beta, state, lens, scale, fresh):
    """ops/kda.py's plain form a token at a time, the state rounded to
    bf16 after each: the control of the KDA state's precision."""
    from gstpu_torch.ops.kda import kda_recurrence_plain
    if fresh:
        state.zero_()
    o = []
    for t in range(q.shape[1]):
        o.append(kda_recurrence_plain(
            q[:, t:t + 1], k[:, t:t + 1], v[:, t:t + 1], g[:, t:t + 1],
            beta[:, t:t + 1], state, (lens > t).int(), scale, False))
        state.copy_(state.bfloat16().float())
    return torch.cat(o, 1)


def readings(cell) -> dict:
    """The comparison's numbers (`numbers`) on llm_pipelines.check_prompts
    in one fire each of one model drawn from the seed: the program's
    (`program`), and two controls a precision below the configuration's:
    every routed expert weight rounded to fp8 e4m3 (`fp8_experts`), and
    the KDA state held in bf16 (`bf16_state`, the plain recurrence
    rounding it after every token). The reference takes the weights as
    drawn. Each fire captures its own decode step."""
    from gstpu_torch.elements.text.llm import LmReply
    from gstpu_torch.models import kimi_linear
    model = kimi_linear.KimiLinearLm.from_seed(
        llm.model_config(cell.config), cell.seed % 2 ** 63, cell.device)
    prompts = llm.check_prompts(cell)
    experts = [lw for lw in model.p["layers"] if "w13" in lw]

    def fire():
        model._step = None
        gen = model.generate(prompts, cell.traffic["max_tokens"],
                             keep=range(len(prompts)))
        model._step = None
        return [LmReply("", p, ids, gen.logits[i], gen.routes[i])
                for i, (p, ids) in enumerate(zip(prompts, gen.ids))]

    out = {"program": numbers(model, fire(), cell.reference)}
    drawn = [(lw["w13"], lw["w2"]) for lw in experts]
    for lw in experts:
        lw["w13"], lw["w2"] = (w.to(torch.float8_e4m3fn).to(w.dtype)
                               for w in (lw["w13"], lw["w2"]))
    replies = fire()
    for lw, (w13, w2) in zip(experts, drawn):
        lw["w13"], lw["w2"] = w13, w2
    # the fire's tap, against the drawn weights
    out["fp8_experts"] = numbers(model, replies, cell.reference)
    kernel = kimi_linear.kda_recurrence
    kimi_linear.kda_recurrence = _bf16_state
    try:
        out["bf16_state"] = numbers(model, fire(), cell.reference)
    finally:
        kimi_linear.kda_recurrence = kernel
    return out
