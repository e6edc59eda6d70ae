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

import pytest
import torch

import gstpu_torch
from gstpu_torch import State, parse_launch
from gstpu_torch.utils import tracing

LAUNCH = ("audiotestsrc num-buffers=2 ! rsaudioecho delay=1000000 ! "
          "queue ! appsink name=sink")


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port on the CPU, in one torch thread (test_torch_streams.py
    says why)."""
    gstpu_torch.init(device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
