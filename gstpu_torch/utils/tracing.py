"""Tracer hook architecture + built-in tracers.

Rebuilds the reference utils/tracers plugin (SURVEY.md §5.1): tracer
objects subscribe to core hook points (pad-push pre/post, state
changes) and record pipeline telemetry. Activation mirrors GStreamer:
    GSTPU_TRACERS="queue-levels(file=/tmp/q.csv);pad-push-timings(file=...)"
or programmatically via install().

Built-ins: queue-levels, pad-push-timings, buffer-lateness,
pcap-writer, memory-tracer, chrome-tracer, fmt-tracer, torch-profiler,
program-spans, pipeline-snapshot (DOT dump helper).

Spans and counters inside the program: `span(name, request=None)` is a
context manager and `count(name, n=1)` adds to a counter. They record
into the installed `program-spans` tracer (`ProgramSpans`); with none
installed a site costs one module-level check and records nothing.
    GSTPU_TRACERS="program-spans(file=/tmp/spans.json,device=1)"
keeps every span from install on and writes them as Chrome-trace JSON
(chrome://tracing, ui.perfetto.dev) at `flush_all()`; `device=1` adds
each stage's interval on the card. Times are `time.perf_counter_ns()`,
the clock a benchmark's host spans use. Nothing installs it by default,
so a run that does not ask for it carries only the sites' checks;
perfbench does not install it (PERF.md §7 says what would). The sites:

Spans (request in brackets; a span without one takes its parent's):
* `chain.step` (step number, from 1): `parallel/chains.py`, a call of
  the exact chain's `step`; inside it one device span a stage of
  `chains.STAGES`, in order: `chain.echo` there, and `chain.meas_in`,
  `chain.fill`, `chain.limiter`, `chain.meas_out`, `chain.gain` in
  `ops/loudnorm_dev.py` `inner_step`;
* `limiter.wait`: `ops/loudnorm_dev.py` `_limiter_frame`, the host
  waiting for the card's answer to the segment loop's test;
* `context.submit` (buffer pts), `context.fire` (fire number),
  `context.distribute` (the number of the fire distributed):
  `runtime/device_batch.py` `DeviceContext`;
* `pipeline.iterate`: `core/bin.py` `Pipeline.iterate`;
  `appsrc.push` (buffer pts), `appsink.pull`:
  `elements/generic/app.py` `push_buffer`, `pull_all`.
Counters:
* `limiter.iterations`: the segment loop's iterations;
* `context.stacked_rows`, `context.stacked_bytes`: the rows and bytes
  `DeviceContext._batch` stacks or uploads into a fire's batch (a bank
  of rows taken whole adds nothing).
"""

from __future__ import annotations

import itertools
import json
import os
import re
import struct
import threading
import time
from collections import defaultdict
from typing import Any, Callable

_hooks: dict[str, list[Callable]] = {}
_active_tracers: list["Tracer"] = []


def dispatch(hook: str, *args) -> None:
    hs = _hooks.get(hook)
    if hs:
        for h in hs:
            h(*args)


def has_hooks(hook: str) -> bool:
    return bool(_hooks.get(hook))


class Tracer:
    """Base tracer: override hook methods and call install()."""

    HOOKS: dict[str, str] = {}  # hook-name -> method name

    def __init__(self, **params):
        self.params = params

    def install(self) -> None:
        for hook, meth in self.HOOKS.items():
            _hooks.setdefault(hook, []).append(getattr(self, meth))
        _active_tracers.append(self)

    def uninstall(self) -> None:
        for hook, meth in self.HOOKS.items():
            fn = getattr(self, meth)
            if fn in _hooks.get(hook, []):
                _hooks[hook].remove(fn)
        if self in _active_tracers:
            _active_tracers.remove(self)

    def flush(self) -> None:
        pass


class PadPushTimings(Tracer):
    """Per-push duration CSV (reference pad_push_timings)."""

    HOOKS = {"pad-push-pre": "pre", "pad-push-post": "post"}

    def __init__(self, file: str = "/tmp/gstpu-pad-push-timings.csv"):
        super().__init__(file=file)
        self._starts: dict[int, float] = {}
        self._f = open(file, "w")
        self._f.write("time,pad,duration_ns\n")

    def pre(self, pad, buf) -> None:
        self._starts[id(pad)] = time.monotonic_ns()

    def post(self, pad, buf) -> None:
        t0 = self._starts.pop(id(pad), None)
        if t0 is not None:
            el = pad.element.name if pad.element else "?"
            self._f.write(f"{time.monotonic_ns()},{el}:{pad.name},"
                          f"{time.monotonic_ns() - t0}\n")

    def flush(self) -> None:
        self._f.flush()


class QueueLevels(Tracer):
    """Queue fill levels over time (reference queue_levels)."""

    HOOKS = {"pad-push-post": "sample"}

    def __init__(self, file: str = "/tmp/gstpu-queue-levels.csv"):
        super().__init__(file=file)
        self._f = open(file, "w")
        self._f.write("time,queue,level\n")

    def sample(self, pad, buf) -> None:
        el = pad.element
        if el is not None and el.ELEMENT_NAME == "queue":
            self._f.write(f"{time.monotonic_ns()},{el.name},"
                          f"{len(el._q)}\n")

    def flush(self) -> None:
        self._f.flush()


class BufferLateness(Tracer):
    """Buffer lateness vs pipeline clock (reference buffer_lateness)."""

    HOOKS = {"pad-push-pre": "sample"}

    def __init__(self, file: str = "/tmp/gstpu-buffer-lateness.csv"):
        super().__init__(file=file)
        self._f = open(file, "w")
        self._f.write("time,pad,pts,lateness_ns\n")

    def sample(self, pad, buf) -> None:
        el = pad.element
        if el is None or el.clock is None or buf.pts is None:
            return
        rt = el.clock.time() - el.base_time
        self._f.write(f"{time.monotonic_ns()},"
                      f"{el.name}:{pad.name},{buf.pts},{rt - buf.pts}\n")

    def flush(self) -> None:
        self._f.flush()


class PcapWriter(Tracer):
    """Captures buffers crossing pads of one element into a .pcap
    file as UDP packets (reference pcap_writer)."""

    HOOKS = {"pad-push-pre": "capture"}

    def __init__(self, file: str = "/tmp/gstpu-capture.pcap",
                 element: str = ""):
        super().__init__(file=file, element=element)
        self._f = open(file, "wb")
        # pcap global header: magic, v2.4, UTC, snaplen, LINKTYPE_RAW=101
        self._f.write(struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0,
                                  65535, 101))

    def capture(self, pad, buf) -> None:
        el = pad.element
        if self.params["element"] and \
                (el is None or el.name != self.params["element"]):
            return
        data = buf.to_bytes()
        # minimal IPv4+UDP encapsulation
        udp = struct.pack(">HHHH", 5004, 5004, 8 + len(data), 0) + data
        ip = struct.pack(">BBHHHBBHII", 0x45, 0, 20 + len(udp), 0, 0, 64,
                         17, 0, 0x7F000001, 0x7F000001) + udp
        now = time.time()
        self._f.write(struct.pack("<IIII", int(now),
                                  int((now % 1) * 1e6), len(ip),
                                  len(ip)))
        self._f.write(ip)

    def flush(self) -> None:
        self._f.flush()


class MemoryTracer(Tracer):
    """Periodic process RSS logging (reference memory_tracer)."""

    HOOKS = {"pad-push-post": "maybe_sample"}

    def __init__(self, file: str = "/tmp/gstpu-memory.csv",
                 interval: float = 1.0):
        super().__init__(file=file)
        self.interval = float(interval)
        self._last = 0.0
        self._f = open(file, "w")
        self._f.write("time,rss_kb\n")

    def maybe_sample(self, pad, buf) -> None:
        now = time.monotonic()
        if now - self._last < self.interval:
            return
        self._last = now
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        kb = int(line.split()[1])
                        self._f.write(f"{time.monotonic_ns()},{kb}\n")
                        break
        except OSError:
            pass

    def flush(self) -> None:
        self._f.flush()


def pipeline_snapshot(pipeline) -> str:
    """DOT graph of a pipeline's topology (reference
    pipeline_snapshot; GST_DEBUG_DUMP_DOT_DIR analogue)."""
    lines = ["digraph pipeline {", "  rankdir=LR;"]
    for el in pipeline.iterate_elements():
        label = f"{el.name}\\n{el.ELEMENT_NAME or type(el).__name__}"
        lines.append(f'  "{el.name}" [shape=box,label="{label}"];')
    for el in pipeline.iterate_elements():
        for pad in el.src_pads():
            if pad.peer is not None and pad.peer.element is not None:
                lines.append(
                    f'  "{el.name}" -> "{pad.peer.element.name}" '
                    f'[label="{pad.name}"];')
    lines.append("}")
    return "\n".join(lines)


class ChromeTracer(Tracer):
    """chrome://tracing / Perfetto JSON trace of pad pushes
    (the reference ships this as the gst-dots/perfetto bridge).
    Each push becomes a complete ("X") duration event on the
    element's named track; load the file in ui.perfetto.dev."""

    HOOKS = {"pad-push-pre": "pre", "pad-push-post": "post"}

    def __init__(self, file: str = "/tmp/gstpu-trace.json"):
        super().__init__(file=file)
        self.file = file
        self._starts: dict[int, int] = {}
        self._events: list[dict] = []

    def pre(self, pad, buf) -> None:
        self._starts[id(pad)] = time.monotonic_ns()

    def post(self, pad, buf) -> None:
        t0 = self._starts.pop(id(pad), None)
        if t0 is None:
            return
        el = pad.element.name if pad.element else "?"
        self._events.append({
            "name": f"{el}:{pad.name}", "ph": "X", "cat": "pad-push",
            "ts": t0 / 1000.0,
            "dur": (time.monotonic_ns() - t0) / 1000.0,
            "pid": 1, "tid": el,
        })

    def flush(self) -> None:
        with open(self.file, "w") as f:
            json.dump({"traceEvents": self._events,
                       "displayTimeUnit": "ns"}, f)


class FmtTracer(Tracer):
    """Human-readable span logging (reference fmttracing: the
    tracing-subscriber fmt layer printing pad push spans). Writes to
    the `gstpu_torch.trace` logger so GSTPU_DEBUG-style config applies."""

    HOOKS = {"pad-push-pre": "pre", "pad-push-post": "post"}

    def __init__(self, level: str = "DEBUG"):
        super().__init__(level=level)
        import logging
        self._log = logging.getLogger("gstpu_torch.trace")
        self._level = getattr(logging, str(level).upper(), 10)
        self._t0: dict[int, int] = {}

    def pre(self, pad, buf) -> None:
        self._t0[id(pad)] = time.monotonic_ns()

    def post(self, pad, buf) -> None:
        t0 = self._t0.pop(id(pad), None)
        if t0 is None:
            return
        el = pad.element.name if pad.element else "?"
        self._log.log(self._level,
                      "pad_push %s:%s %.1fus", el, pad.name,
                      (time.monotonic_ns() - t0) / 1000.0)


class TorchProfilerTracer(Tracer):
    """Profiling bridge (the port's counterpart of gstpu's
    JaxProfilerTracer): runs the pipeline's dataflow under
    torch.profiler, so device kernels land in a Chrome trace beside a
    `pad_push:<element>:<pad>` span for each pad push.

    Pad pushes run on the threads that drive the pipelines (each
    `run_async` starts one), and a plain profile records only the thread
    that started it; the profile is taken over all threads
    (`profile_all_threads`)."""

    HOOKS = {"pad-push-pre": "pre", "pad-push-post": "post"}

    def __init__(self, logdir: str | None = None):
        import tempfile
        logdir = logdir or os.path.join(tempfile.gettempdir(),
                                        "gstpu-torch-trace")
        super().__init__(logdir=logdir)
        self.logdir = logdir
        self.trace_path: str | None = None
        self._spans: dict[int, Any] = {}
        self._prof = None

    def install(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        from gstpu_torch.core.device import default_device
        acts = [ProfilerActivity.CPU]
        if default_device().type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(
            activities=acts,
            experimental_config=torch._C._profiler._ExperimentalConfig(
                profile_all_threads=True))
        self._prof.start()
        super().install()

    def pre(self, pad, buf) -> None:
        from torch.profiler import record_function
        el = pad.element.name if pad.element else "?"
        span = record_function(f"pad_push:{el}:{pad.name}")
        span.__enter__()
        self._spans[id(pad)] = span

    def post(self, pad, buf) -> None:
        span = self._spans.pop(id(pad), None)
        if span is not None:
            span.__exit__(None, None, None)

    def flush(self) -> None:
        """Close any open spans, stop the profile and write its Chrome
        trace into logdir (`trace_path`)."""
        if self._prof is None:
            return
        for span in list(self._spans.values()):
            span.__exit__(None, None, None)
        self._spans.clear()
        self._prof.stop()
        os.makedirs(self.logdir, exist_ok=True)
        self.trace_path = os.path.join(
            self.logdir, f"trace-{os.getpid()}-{time.time_ns()}.json")
        self._prof.export_chrome_trace(self.trace_path)
        self._prof = None


# -- spans and counters inside the program ---------------------------------

_program: "ProgramSpans | None" = None


class _NoSpan:
    """What a span site gets where no program-spans tracer is
    installed."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()


def span(name: str, request=None, device: bool = False):
    """A span of the program, `with span(...):`. `name` is
    `<layer>.<what>`; `request` ties the span to one request (a step, a
    fire, a buffer's pts), and a span without one takes its parent's;
    `device` marks a stage whose work on the card the tracer times where
    it is installed with `device` on. Records nothing where no
    program-spans tracer is installed."""
    p = _program
    if p is None:
        return _NO_SPAN
    return _Span(p._local.th, name, request, device)


def count(name: str, n: int = 1) -> None:
    """Add n to the program's counter `name`, where a program-spans
    tracer is installed."""
    p = _program
    if p is not None:
        p.count(name, n)


class _Thread:
    """One thread's open spans and what it recorded. Only its own thread
    writes it (but `reset`), so the span sites take no lock."""

    __slots__ = ("tracer", "stack", "names", "layers", "sums",
                 "layer_sums", "counters", "intervals", "samples",
                 "device")

    def __init__(self, tracer: "ProgramSpans"):
        self.tracer = tracer
        self.stack: list = []        # the open spans, innermost last
        self.names: list = []        # their names
        self.layers: list = []       # their layers
        self.clear()

    def clear(self) -> None:
        self.sums: dict = {}         # name -> [total_ns, self_ns, calls]
        self.layer_sums: dict = {}   # layer -> [ns, calls]
        self.counters: dict = {}
        self.intervals: list = []
        self.samples: list = []
        self.device: list = []


class _Local(threading.local):
    def __init__(self, tracer: "ProgramSpans"):
        self.th = _Thread(tracer)
        with tracer._lock:
            tracer._threads.append(self.th)


class _Span:
    __slots__ = ("th", "name", "layer", "request", "device", "id",
                 "parent", "t0", "child_ns", "ev0", "outer", "outer_layer")

    def __init__(self, th: _Thread, name: str, request, device: bool):
        self.th, self.name = th, name
        self.request, self.device = request, device

    def __enter__(self):
        th, name = self.th, self.name
        tr = th.tracer
        layer = tr._layer_of.get(name)
        if layer is None:
            layer = tr._layer_of[name] = name.partition(".")[0]
        self.layer = layer
        stack = th.stack
        parent = stack[-1] if stack else None
        self.parent = parent
        if self.request is None and parent is not None:
            self.request = parent.request
        self.outer = name not in th.names
        self.outer_layer = layer not in th.layers
        stack.append(self)
        th.names.append(name)
        th.layers.append(layer)
        self.child_ns = 0
        self.ev0 = None
        if tr.keeping:
            self.id = next(tr._ids)
            if self.device and tr.device:
                self.ev0 = tr._mark()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        th, name = self.th, self.name
        tr = th.tracer
        ev1 = tr._mark() if self.ev0 is not None else None
        th.stack.pop()
        th.names.pop()
        th.layers.pop()
        dur = t1 - self.t0
        parent = self.parent
        if parent is not None:
            parent.child_ns += dur
        v = th.sums.get(name)
        if v is None:
            v = th.sums[name] = [0, 0, 0]
        v[1] += dur - self.child_ns
        if self.outer:
            v[0] += dur
            v[2] += 1
        if self.outer_layer:
            v = th.layer_sums.get(self.layer)
            if v is None:
                v = th.layer_sums[self.layer] = [0, 0]
            v[0] += dur
            v[1] += 1
        if tr.keeping:
            th.intervals.append(
                (self.t0, t1, name, self.id,
                 parent.id if parent is not None else 0, self.request,
                 threading.get_ident()))
            if ev1 is not None:
                th.device.append((self.ev0, ev1, name, self.id,
                                  self.request))
        return False


class ProgramSpans(Tracer):
    """`program-spans`: sums, counters and, while asked, intervals of the
    program's spans (`span`, `count`), on `time.perf_counter_ns()`.

    For each span name it sums the time and calls of its outermost spans
    (a name nested in itself counts once) and the self time of all of
    them (a span's duration less its children's); for each layer (the
    name up to its first dot) the time and calls of the layer's
    outermost spans, so `context.fire` inside `context.submit` counts
    once. `snapshot()` adds up every thread's. A span's parent is the
    innermost span open on its own thread.

    Intervals (start_ns, end_ns, name, id, parent id, request, thread)
    and counter samples (each thread's running count) are kept between
    `keep(True)` and `keep(False)`, or from the start where `file` is
    given; `flush()` writes them to `file` as Chrome-trace JSON. With
    `device` on, a span opened with device=True while intervals are kept
    records a timing event on the current CUDA stream where it opens and
    where it closes: `device_intervals()` gives its work on the card in
    stream order, on the host clock through an anchor event taken on an
    idle card when keeping starts. Without CUDA the work is done when
    each call returns, and the host times stand in.

    Each thread records into its own sums, so the span sites take no
    lock; `reset` and `snapshot` are exact while no other thread is
    inside a span."""

    SUMS = ("total_ns", "self_ns", "calls", "layer_ns", "layer_calls",
            "counters")

    def __init__(self, file: str | None = None, device=False):
        super().__init__(file=file, device=device)
        self.file = file or None
        self.device = str(device).lower() in ("1", "true", "yes", "on")
        self.keeping = False
        self._lock = threading.Lock()
        self._threads: list[_Thread] = []
        self._local = _Local(self)
        self._layer_of: dict[str, str] = {}
        self._ids = itertools.count(1)
        self._cuda = None           # (torch.cuda, anchor event, its ns)
        if self.file:
            self.keep(True)

    def install(self) -> None:
        """Make this the tracer that `span` and `count` record into."""
        global _program
        super().install()
        _program = self

    def uninstall(self) -> None:
        global _program
        super().uninstall()
        if _program is self:
            _program = None

    def _each(self) -> list[_Thread]:
        with self._lock:
            return list(self._threads)

    def reset(self) -> None:
        """Clear every sum, counter, interval and sample."""
        for th in self._each():
            th.clear()

    def keep(self, on: bool = True) -> None:
        """Start (True) or stop keeping intervals, counter samples and
        device events; the sums are kept either way."""
        if on and not self.keeping and self.device:
            self._anchor()
        self.keeping = bool(on)

    def _anchor(self) -> None:
        import torch
        if not torch.cuda.is_available():
            self._cuda = None
            return
        torch.cuda.synchronize()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        ev.synchronize()
        self._cuda = (torch.cuda, ev, time.perf_counter_ns())

    def _mark(self):
        """A device boundary: a timing event on the current stream, or
        the host's time where there is no card."""
        if self._cuda is None:
            return time.perf_counter_ns()
        ev = self._cuda[0].Event(enable_timing=True)
        ev.record()
        return ev

    def count(self, name: str, n: int = 1) -> None:
        th = self._local.th
        v = th.counters.get(name, 0) + n
        th.counters[name] = v
        if self.keeping:
            th.samples.append((time.perf_counter_ns(), name, v))

    def snapshot(self) -> dict:
        """{sum: {name: int}} for each of SUMS, over every thread."""
        out = {k: defaultdict(int) for k in self.SUMS}
        for th in self._each():
            for name, (total, own, calls) in list(th.sums.items()):
                if calls:
                    out["total_ns"][name] += total
                    out["calls"][name] += calls
                out["self_ns"][name] += own
            for layer, (ns, calls) in list(th.layer_sums.items()):
                out["layer_ns"][layer] += ns
                out["layer_calls"][layer] += calls
            for name, v in list(th.counters.items()):
                out["counters"][name] += v
        return {k: dict(v) for k, v in out.items()}

    def intervals(self) -> list:
        """The kept spans, (start_ns, end_ns, name, id, parent id,
        request, thread), by thread in the order they closed."""
        return [iv for th in self._each() for iv in th.intervals]

    def device_intervals(self) -> list:
        """(start_ns, end_ns, name, id, request) of each device span's
        work on the card, on the host clock; waits for the card."""
        kept = [d for th in self._each() for d in th.device]
        if self._cuda is None or not kept:
            return kept
        cuda, anchor, t = self._cuda
        cuda.synchronize()

        def host(ev) -> int:
            return t + round(anchor.elapsed_time(ev) * 1e6)
        return [(host(a), host(b), n, i, r) for a, b, n, i, r in kept]

    def chrome_trace(self) -> dict:
        """The kept spans, device intervals and counter samples as a
        Chrome-trace document (times in us)."""
        pid = os.getpid()
        events = [{"name": n, "ph": "X", "cat": n.partition(".")[0],
                   "ts": a / 1e3, "dur": (b - a) / 1e3, "pid": pid,
                   "tid": tid, "args": {"id": i, "parent": p,
                                        "request": r}}
                  for a, b, n, i, p, r, tid in self.intervals()]
        events += [{"name": n, "ph": "X", "cat": "device", "ts": a / 1e3,
                    "dur": (b - a) / 1e3, "pid": pid, "tid": "device",
                    "args": {"id": i, "request": r}}
                   for a, b, n, i, r in self.device_intervals()]
        events += [{"name": n, "ph": "C", "ts": t / 1e3, "pid": pid,
                    "args": {n: v}}
                   for th in self._each() for t, n, v in th.samples]
        return {"traceEvents": events, "displayTimeUnit": "ns"}

    def flush(self) -> None:
        """Write the Chrome trace to `file`, where one is given."""
        if self.file:
            with open(self.file, "w") as f:
                json.dump(self.chrome_trace(), f, default=str)


_TRACERS = {
    "pad-push-timings": PadPushTimings,
    "queue-levels": QueueLevels,
    "buffer-lateness": BufferLateness,
    "pcap-writer": PcapWriter,
    "memory-tracer": MemoryTracer,
    "chrome-tracer": ChromeTracer,
    "fmt-tracer": FmtTracer,
    "torch-profiler": TorchProfilerTracer,
    "program-spans": ProgramSpans,
}


def init_from_env() -> list[Tracer]:
    """Parse GSTPU_TRACERS and install the requested tracers."""
    spec = os.environ.get("GSTPU_TRACERS", "")
    out = []
    for part in filter(None, spec.split(";")):
        m = re.fullmatch(r"([\w-]+)(?:\((.*)\))?", part.strip())
        if not m:
            continue
        name, args = m.group(1), m.group(2) or ""
        cls = _TRACERS.get(name)
        if cls is None:
            continue
        kwargs = {}
        for kv in filter(None, args.split(",")):
            k, _, v = kv.partition("=")
            kwargs[k.strip().replace("-", "_")] = v.strip()
        t = cls(**kwargs)
        t.install()
        out.append(t)
    return out


def flush_all() -> None:
    for t in _active_tracers:
        t.flush()
