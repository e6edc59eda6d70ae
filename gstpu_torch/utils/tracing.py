"""Tracer hook architecture + built-in tracers.

Rebuilds the reference utils/tracers plugin (SURVEY.md §5.1): tracer
objects subscribe to core hook points (pad-push pre/post, state
changes) and record pipeline telemetry. Activation mirrors GStreamer:
    GSTPU_TRACERS="queue-levels(file=/tmp/q.csv);pad-push-timings(file=...)"
or programmatically via install().

Built-ins: queue-levels, pad-push-timings, buffer-lateness,
pcap-writer, memory-tracer, chrome-tracer, fmt-tracer, torch-profiler,
pipeline-snapshot (DOT dump helper).
"""

from __future__ import annotations

import os
import re
import struct
import time
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
        import json
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


_TRACERS = {
    "pad-push-timings": PadPushTimings,
    "queue-levels": QueueLevels,
    "buffer-lateness": BufferLateness,
    "pcap-writer": PcapWriter,
    "memory-tracer": MemoryTracer,
    "chrome-tracer": ChromeTracer,
    "fmt-tracer": FmtTracer,
    "torch-profiler": TorchProfilerTracer,
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
