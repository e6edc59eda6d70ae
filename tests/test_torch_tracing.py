"""The port's torch-profiler tracer (gstpu_torch.utils.tracing.
TorchProfilerTracer), the twin of tests/test_validate.py::
test_jax_profiler_tracer.

A pipeline's pad pushes run on the thread that drives it (its `queue` is
a cooperative task of the pipeline's loop, as in gstpu, not a thread of
its own), and a profile records only its own thread unless it is told
otherwise. So two pipelines of the same string run under the tracer,
each driven by a streaming thread of its own (`run_async`), and the
Chrome trace must hold pad_push spans from both threads."""

import glob
import json
import os
import sys
import threading

import pytest

import gstpu_torch
from gstpu_torch import State, parse_launch
from gstpu_torch.utils import tracing
from torch_session import torch_test_limit  # noqa: F401

LAUNCH = ("audiotestsrc num-buffers=2 ! rsaudioecho delay=1000000 ! "
          "queue ! appsink name=sink")


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port on the CPU."""
    gstpu_torch.init(device="cpu")


def _run(tracer) -> None:
    try:
        pipes = [parse_launch(LAUNCH) for _ in range(2)]
        for p in pipes:
            p.set_state(State.PLAYING)
        threads = [p.run_async() for p in pipes]
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        for p in pipes:
            assert len(p.get_by_name("sink").pull_all()) == 2
            p.set_state(State.NULL)
    finally:
        tracer.flush()
        tracer.uninstall()


def _pad_push_threads(path) -> dict:
    """{tid: names} of the pad_push spans in a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("name", "").startswith("pad_push:"):
            out.setdefault(e["tid"], set()).add(e["name"])
    return out


def _check_trace(logdir) -> None:
    files = glob.glob(os.path.join(logdir, "*.json"))
    assert len(files) == 1, files
    spans = _pad_push_threads(files[0])
    assert len(spans) == 2, spans
    for names in spans.values():
        # each thread pushed from the source, the echo and the queue
        assert sorted(n.split(":")[1].rstrip("0123456789")
                      for n in names) == ["audiotestsrc", "queue",
                                          "rsaudioecho"], names


def test_torch_profiler_tracer(tmp_path):
    t = tracing.TorchProfilerTracer(logdir=str(tmp_path / "trace"))
    t.install()
    _run(t)
    assert t.trace_path is not None
    _check_trace(tmp_path / "trace")


def test_torch_profiler_from_env(tmp_path, monkeypatch):
    """GSTPU_TRACERS=torch-profiler(logdir=...) through init_from_env."""
    logdir = tmp_path / "env-trace"
    monkeypatch.setenv("GSTPU_TRACERS", f"torch-profiler(logdir={logdir})")
    tracers = tracing.init_from_env()
    assert [type(t) for t in tracers] == [tracing.TorchProfilerTracer]
    _run(tracers[0])
    _check_trace(logdir)


# -- the program's spans and counters (program-spans) -----------------------

class _Clock:
    """A perf_counter_ns that moves only when a test moves it."""

    def __init__(self):
        self.t = 1_000

    def __call__(self) -> int:
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(tracing.time, "perf_counter_ns", c)
    return c


@pytest.fixture
def spans():
    t = tracing.ProgramSpans()
    t.install()
    yield t
    t.uninstall()


def _empty(t) -> dict:
    return {k: {} for k in t.SUMS}


def test_spans_record_nothing_without_the_tracer():
    t = tracing.ProgramSpans()
    with tracing.span("layer.work", 1) as s:
        tracing.count("layer.items", 5)
    assert s is None
    assert t.snapshot() == _empty(t)
    t.install()
    with tracing.span("layer.work", 1) as s:
        tracing.count("layer.items", 5)
    assert s is not None and t.snapshot()["counters"] == {"layer.items": 5}
    t.uninstall()
    t.reset()
    with tracing.span("layer.work") as s:
        tracing.count("layer.items")
    assert s is None
    assert t.snapshot() == _empty(t)


def test_nesting_keeps_outermost_counts_and_self_time(spans, clock):
    with tracing.span("ctx.submit"):
        clock.t += 10
        with tracing.span("ctx.fire"):
            clock.t += 20
            with tracing.span("ctx.fire"):      # a name inside itself
                clock.t += 5
            clock.t += 30
        clock.t += 1
        with tracing.span("other.x"):
            clock.t += 4
    s = spans.snapshot()
    assert s["total_ns"] == {"ctx.submit": 70, "ctx.fire": 55, "other.x": 4}
    assert s["calls"] == {"ctx.submit": 1, "ctx.fire": 1, "other.x": 1}
    # self: 70 - 55 - 4; the outer fire's 55 - 5 and the inner's 5
    assert s["self_ns"] == {"ctx.submit": 11, "ctx.fire": 55, "other.x": 4}
    # a layer counts its outermost span once
    assert s["layer_ns"] == {"ctx": 70, "other": 4}
    assert s["layer_calls"] == {"ctx": 1, "other": 1}


def test_reset_clears_and_intervals_are_kept_only_while_asked(spans,
                                                              clock):
    with tracing.span("a.x", 7):
        clock.t += 3
    tracing.count("a.n", 2)
    assert spans.intervals() == []
    spans.keep(True)
    with tracing.span("a.x", 8):
        with tracing.span("a.y"):
            clock.t += 2
    tracing.count("a.n")
    spans.keep(False)
    with tracing.span("a.x"):
        clock.t += 1
    kept = spans.intervals()
    assert [(n, r) for _, _, n, _, _, r, _ in kept] == [("a.y", 8),
                                                       ("a.x", 8)]
    (y, x) = kept
    assert y[4] == x[3] and x[4] == 0          # a.y's parent is a.x
    assert (y[0], y[1]) == (1_003, 1_005)
    s = spans.snapshot()
    assert s["calls"]["a.x"] == 3 and s["counters"] == {"a.n": 3}
    counters = [e for e in spans.chrome_trace()["traceEvents"]
                if e["ph"] == "C"]
    assert [e["args"] for e in counters] == [{"a.n": 3}]
    spans.reset()
    assert spans.snapshot() == _empty(spans)
    assert spans.intervals() == [] and spans.device_intervals() == []
    assert spans.chrome_trace()["traceEvents"] == []


def test_spans_on_threads_keep_their_own_parents(spans):
    """More threads than cores, switching as often as the interpreter
    allows: each span's parent is on its own thread, and no call or
    count is lost."""
    spans.keep(True)
    n_threads, n_spans = 4 * (os.cpu_count() or 1), 200

    def work(k):
        for _ in range(n_spans):
            with tracing.span("t.outer", k):
                with tracing.span("t.inner"):
                    tracing.count("t.n")

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(switch)
    kept = spans.intervals()
    by_id = {i: (n, r, tid) for _, _, n, i, _, r, tid in kept}
    inner = [(p, r, tid) for _, _, n, _, p, r, tid in kept
             if n == "t.inner"]
    total = n_threads * n_spans
    assert len(inner) == total and len(by_id) == 2 * total
    for p, r, tid in inner:
        assert by_id[p] == ("t.outer", r, tid)
    s = spans.snapshot()
    assert s["calls"] == {"t.outer": total, "t.inner": total}
    assert s["counters"] == {"t.n": total}


def test_program_spans_from_env_write_a_chrome_trace(tmp_path,
                                                     monkeypatch):
    """GSTPU_TRACERS=program-spans(file=...,device=1): the pipeline's
    spans and a device span (host times on the CPU) in a Chrome trace
    that loads as JSON."""
    path = tmp_path / "spans.json"
    monkeypatch.setenv("GSTPU_TRACERS",
                       f"program-spans(file={path},device=1)")
    (t,) = tracing.init_from_env()
    try:
        p = parse_launch("audiotestsrc num-buffers=2 ! appsink name=sink")
        p.set_state(State.PLAYING)
        p.run()
        assert len(p.get_by_name("sink").pull_all()) == 2
        p.set_state(State.NULL)
        with tracing.span("chain.stage", 3, device=True):
            tracing.count("chain.items", 4)
        tracing.flush_all()
    finally:
        t.uninstall()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans_by_name = {e["name"] for e in events if e["ph"] == "X"
                     and e["tid"] != "device"}
    assert {"pipeline.iterate", "appsink.pull",
            "chain.stage"} <= spans_by_name
    (dev,) = [e for e in events if e.get("tid") == "device"]
    assert dev["name"] == "chain.stage" and dev["args"]["request"] == 3
    assert [e["args"] for e in events if e["ph"] == "C"] == [
        {"chain.items": 4}]
