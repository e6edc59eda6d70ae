"""gst-validate analogue: scenario-driven pipeline checks.

Rebuilds the shape of GStreamer's validate tooling that the reference
plugs into (utils/validate/src/: plugin registering custom validate
actions, notably check_last_frame_qrcode.rs): a scenario is a list of
timed actions executed against a running pipeline, each producing a
report. The built-in action set mirrors gst-validate's core
(description/set-state/seek/wait/eos/stop/check-position/
check-last-sample) plus the reference's custom
`check-last-frame-qrcode` action — whose QR decoding is pluggable
because this image ships no QR decoder (pyzbar/cv2 absent; env gate
documented in PARITY.md).

Scenario text uses gst-validate's .scenario syntax:

    description, summary="playback sanity"
    wait, duration=0.05
    check-position, expected-position=0.04
    check-last-sample, sink-name=sink, checksum=9a0364b9...
    eos

The port's copy of gstpu/utils/validate.py: host code.
"""

from __future__ import annotations

import hashlib
import json
import time
from dataclasses import dataclass, field

from gstpu_torch.core.element import State

SECOND = 1_000_000_000


# ---------------------------------------------------------------------------
# reports (gst-validate's report/issue system, simplified)
# ---------------------------------------------------------------------------

@dataclass
class Report:
    action: str
    level: str          # "ok" | "error" | "skipped"
    message: str = ""

    @property
    def ok(self) -> bool:
        return self.level != "error"


# ---------------------------------------------------------------------------
# scenario parsing
# ---------------------------------------------------------------------------

@dataclass
class Action:
    name: str
    fields: dict = field(default_factory=dict)


def _parse_value(v: str):
    v = v.strip()
    if v.startswith('"') and v.endswith('"'):
        return v[1:-1]
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        pass
    return v


def parse_scenario(text: str) -> list[Action]:
    actions = []
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parts = []
        cur, inq, esc = "", False, False
        for ch in line:
            if esc:
                cur += ch
                esc = False
                continue
            if ch == "\\" and inq:
                esc = True
                continue
            if ch == '"':
                inq = not inq
            if ch == "," and not inq:
                parts.append(cur)
                cur = ""
            else:
                cur += ch
        parts.append(cur)
        name = parts[0].strip()
        fields = {}
        for p in parts[1:]:
            if "=" not in p:
                continue
            k, v = p.split("=", 1)
            fields[k.strip()] = _parse_value(v)
        actions.append(Action(name, fields))
    return actions


# ---------------------------------------------------------------------------
# action implementations
# ---------------------------------------------------------------------------

# pluggable QR decoder: fn(np.ndarray HxWx3 RGB) -> list[str]
# (the reference decodes with the `image` + `rqrr` crates; this env has
# no QR decoder, so apps/tests inject one)
QR_DECODER = None


def _find_sink(pipeline, fields):
    name = fields.get("sink-name")
    if name:
        el = pipeline.get_by_name(name)
        if el is None:
            raise LookupError(f"no element named {name!r}")
        return el
    factory = fields.get("sink-factory-name")
    for el in pipeline.iterate_elements():
        if factory and type(el).ELEMENT_NAME == factory:
            return el
        if not factory and hasattr(el, "pull_all"):
            return el
    raise LookupError("no matching sink found")


def _last_sample(sink):
    sample = getattr(sink, "last_sample", None)
    if sample is None:
        samples = getattr(sink, "samples", None)
        if samples:
            sample = samples[-1]
    if sample is None:
        raise LookupError(f"sink {sink.name!r} holds no last sample")
    return sample


class ScenarioRunner:
    """Executes actions against a pipeline, collecting reports."""

    def __init__(self, pipeline, actions: list[Action] | str):
        self.pipeline = pipeline
        self.actions = (parse_scenario(actions)
                        if isinstance(actions, str) else actions)
        self.reports: list[Report] = []

    # -- driving ---------------------------------------------------------
    def run(self) -> bool:
        for action in self.actions:
            handler = getattr(self, "_act_" + action.name
                              .replace("-", "_"), None)
            if handler is None:
                self._report(action.name, "error",
                             f"unknown action {action.name!r}")
                continue
            try:
                handler(action.fields)
            except Exception as e:  # report, don't abort the scenario
                self._report(action.name, "error", str(e))
        return all(r.ok for r in self.reports)

    def _report(self, action: str, level: str, msg: str = "") -> None:
        self.reports.append(Report(action, level, msg))

    # -- core gst-validate actions ----------------------------------------
    def _act_description(self, f) -> None:
        self._report("description", "ok", str(f.get("summary", "")))

    def _act_set_state(self, f) -> None:
        state = getattr(State, str(f.get("state", "playing")).upper())
        self.pipeline.set_state(state)
        self._report("set-state", "ok", state.name)

    def _act_wait(self, f) -> None:
        dur = float(f.get("duration", 0))
        deadline = time.monotonic() + dur
        while time.monotonic() < deadline:
            self.pipeline.iterate()
            time.sleep(0.001)
        self._report("wait", "ok")

    def _act_eos(self, f) -> None:
        # drive until the pipeline posts EOS
        timeout = float(f.get("timeout", 10))
        self.pipeline.run(timeout=timeout)
        self._report("eos", "ok")

    def _act_stop(self, f) -> None:
        self.pipeline.set_state(State.NULL)
        self._report("stop", "ok")

    def _act_seek(self, f) -> None:
        start = int(float(f.get("start", 0)) * SECOND)
        # route to any element exposing seek() (e.g. rtspsrc2),
        # else push a SeekEvent into the pipeline's sources
        from gstpu_torch.core.event import SeekEvent
        for el in self.pipeline.iterate_elements():
            if hasattr(el, "seek") and callable(el.seek):
                if el.seek(start):
                    self._report("seek", "ok", f"start={start}")
                    return
        raise LookupError("no seekable element in the pipeline")

    def _act_check_position(self, f) -> None:
        expected = int(float(f["expected-position"]) * SECOND)
        tolerance = int(float(f.get("tolerance", 0.5)) * SECOND)
        pos = self.pipeline.query_position() \
            if hasattr(self.pipeline, "query_position") else None
        if pos is None:
            # fall back to the last sample's pts on any appsink
            for el in self.pipeline.iterate_elements():
                if hasattr(el, "samples") and el.samples:
                    pos = el.samples[-1].pts
                    break
        if pos is None:
            raise LookupError("no position source")
        if abs(pos - expected) > tolerance:
            raise AssertionError(
                f"position {pos} vs expected {expected} "
                f"(tolerance {tolerance})")
        self._report("check-position", "ok", f"pos={pos}")

    # -- sample checks -----------------------------------------------------
    def _act_check_last_sample(self, f) -> None:
        sink = _find_sink(self.pipeline, f)
        sample = _last_sample(sink)
        data = sample.to_bytes()
        want = f.get("checksum")
        if want is not None:
            got = hashlib.sha256(data).hexdigest()
            if got != want:
                raise AssertionError(f"checksum {got} != {want}")
        self._report("check-last-sample", "ok",
                     f"{len(data)} bytes")

    def _act_check_last_frame_qrcode(self, f) -> None:
        """Reference custom action (utils/validate/src/
        check_last_frame_qrcode.rs): decode QR codes from the sink's
        last frame, JSON-parse them, check expected fields."""
        if QR_DECODER is None:
            self._report("check-last-frame-qrcode", "skipped",
                         "no QR decoder in this environment "
                         "(pyzbar/cv2 absent); set "
                         "gstpu_torch.utils.validate.QR_DECODER")
            return
        sink = _find_sink(self.pipeline, f)
        sample = _last_sample(sink)
        caps = getattr(sink, "caps", None)
        from gstpu_torch.core.video import VideoInfo
        info = VideoInfo.from_caps(caps)
        frame = info.view(sample)
        texts = QR_DECODER(frame)
        if not texts:
            raise AssertionError("no QR code decoded from last frame")
        expected = f.get("expected-fields")
        if expected:
            want = json.loads(expected) \
                if isinstance(expected, str) else expected
            merged = {}
            for t in texts:
                try:
                    merged.update(json.loads(t))
                except json.JSONDecodeError:
                    continue
            for k, v in want.items():
                if merged.get(k) != v:
                    raise AssertionError(
                        f"field {k!r}: {merged.get(k)!r} != {v!r}")
        self._report("check-last-frame-qrcode", "ok",
                     f"{len(texts)} code(s)")


def run_scenario(pipeline, scenario: str) -> list[Report]:
    """Convenience: run a scenario text against a pipeline and return
    the reports (gst-validate's CLI shape as a library call)."""
    runner = ScenarioRunner(pipeline, scenario)
    runner.run()
    return runner.reports
