"""The program's spans on the profiler's timeline, on the card.

A span's host times are `time.perf_counter_ns()`, the clock of the
harness's own spans, and go onto the profiler's (wall) clock by the one
offset `timing.Trace` takes. A kernel launched inside a span and waited
for there must land inside the span's interval on that timeline; with
device boundaries on, inside the span's device interval too (CUDA events
on the host clock through the tracer's anchor). Within 50 us both.
"""

import time

import pytest
import torch

from perfbench.timing import _device_ops

SLACK_US = 50.0


@pytest.mark.card
@pytest.mark.parametrize("where", ["host", "device"])
def test_a_kernel_lands_inside_its_span(card, where):
    from gstpu_torch.utils import tracing
    spans = tracing.ProgramSpans(device=where == "device")
    x = torch.ones(1 << 24, device=card)
    x.mul_(1.0)
    torch.cuda.synchronize()
    spans.install()
    spans.keep(True)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            wall_us = (time.time() - time.perf_counter()) * 1e6
            for k in range(5):
                with tracing.span("test.kernel", k, device=True):
                    x.mul_(1.0001)
                    torch.cuda.synchronize()
                time.sleep(0.002)
    finally:
        spans.uninstall()
    ops = sorted((a, b) for n, a, b in _device_ops(prof)
                 if "mul" in n.lower())
    kept = spans.device_intervals() if where == "device" \
        else spans.intervals()
    got = sorted((a / 1e3 + wall_us, b / 1e3 + wall_us)
                 for a, b, *_ in kept)
    assert len(ops) == len(got) == 5
    for (s, e), (a, b) in zip(ops, got):
        assert a - SLACK_US <= s and e <= b + SLACK_US, (s - a, b - e)
