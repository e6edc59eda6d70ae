"""The port's launch and inspect tools and its gst-validate analogue
against gstpu's, on the CPU.

Twins of tests/test_tools.py's launch and inspect cases (the port's tools
run with `--device cpu`; gstpu's docs-cache and signalling-server cases
wait for their modules) and of tests/test_validate.py but its JAX
profiler case. Each twin runs the gstpu test's body with both packages'
names and compares what it saw, the package's own name taken out of the
text. Then the launch tool as `chip_smoke.py`'s phase 16d runs it: a
subprocess that asks for the card by default and refuses to go on
without one.
"""

import hashlib
import io
import json
import logging
import os
import re
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
import gstpu
import gstpu_torch
from test_torch_captions import Pkg, _both
from torch_session import torch_test_limit  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
REWRITTEN = {"audiornnoise", "burn-yoloxinference", "colorlut", "demucs",
             "ffv1enc", "hsvfilter", "llamacpp-texttransform",
             "llamatexttransform", "rav1enc", "rsaudioecho",
             "yoloxinference"}


@pytest.fixture(autouse=True)
def _both_on_cpu():
    """gstpu's registry and the port's, the port on the CPU."""
    gstpu.init()
    gstpu_torch.init(device="cpu")


def _neutral(P, text):
    """Text with the package's name and the instance counters taken
    out."""
    return re.sub(r"\d+", "#", text.replace(P.name + ".", "PKG."))


def _tool(P, tool, *argv):
    """A tool's main() on `argv` (the port's with --device cpu): its exit
    code, stdout and stderr."""
    main = P.mod(f"tools.{tool}").main
    args = list(argv) + (["--device", "cpu"] if P.name == "gstpu_torch"
                         else [])
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = main(args)
    return rc, out.getvalue(), err.getvalue()


# ---------------------------------------------------------------------------
# launch and inspect (tests/test_tools.py)
# ---------------------------------------------------------------------------

def test_launch_runs_pipeline():
    def body(P):
        rc, out, err = _tool(P, "launch", "-q",
                             "audiotestsrc num-buffers=3 ! fakesink")
        assert rc == 0
        return rc, out, err
    _both(body)


def test_launch_bad_pipeline_errors():
    def body(P):
        rc, out, err = _tool(P, "launch", "-q", "nosuchelement ! fakesink")
        assert rc == 1 and "could not construct" in err
        return rc, out, _neutral(P, err).replace(P.name, "PKG")
    _both(body)


def test_inspect_lists_and_describes():
    """gstpu and the port each list the same 268 factories, in the same
    order; each is described as gstpu describes it, but the elements the
    port rewrote around its device code, whose docstrings and blurbs say
    so, and demucs, whose pads take their channels as a range
    (test_torch_models.py::test_demucs_follows_a_transform). The mock
    elements that tests register in this process (test_cccombiner.py
    leaves its own in gstpu's registry) are not counted."""
    seen = {}

    def body(P):
        rc, out, err = _tool(P, "inspect")
        assert rc == 0
        factory = P.mod("core.registry").element_factory
        names = [n for n in out.split() if factory(n).__module__
                 .startswith(P.name + ".")]
        assert "rsaudioecho" in names and "intersrc" in names
        seen[P.name] = names
        rc, text, _ = _tool(P, "inspect", "audioloudnorm")
        assert rc == 0 and "Pad Templates:" in text
        assert "Element Properties:" in text and "loudness_target" in text
        bad = _tool(P, "inspect", "definitely-not-an-element")
        assert bad[0] == 1
        return text.replace(P.name + ".", "PKG."), bad[0], bad[2]
    _both(body)
    assert len(seen["gstpu"]) == len(seen["gstpu_torch"]) == 268
    assert seen["gstpu_torch"] == seen["gstpu"]
    reg = Pkg("gstpu").mod("tools.inspect"), Pkg("gstpu_torch").mod(
        "tools.inspect")

    def described(i, name):
        # which templates list A420 depends on import order in a process
        # (test_torch_imports.py::test_a420_templates_match_gstpu)
        return reg[i].describe(name).replace("gstpu_torch.", "gstpu.") \
            .replace(",A420", "")
    for name in set(seen["gstpu_torch"]) - REWRITTEN:
        assert described(1, name) == described(0, name), name


def test_launch_messages_flag_tees_bus():
    def body(P):
        rc, out, err = _tool(P, "launch", "-m", "audiotestsrc num-buffers=3"
                             " ! ebur128level interval=10000000 ! fakesink")
        assert rc == 0 and "[bus]" in err and "Execution ended" in err
        return rc, [_neutral(P, line) for line in err.splitlines()
                    if line.startswith("[bus]")]
    _both(body)


# ---------------------------------------------------------------------------
# the gst-validate analogue (tests/test_validate.py)
# ---------------------------------------------------------------------------

def _reports(P, runner):
    return [(r.action, r.level, _neutral(P, r.message))
            for r in runner.reports]


def test_parse_scenario():
    def body(P):
        acts = P.mod("utils.validate").parse_scenario('''
# comment
description, summary="sanity check", seek=false
wait, duration=0.5
check-last-sample, sink-name=sink, checksum=abc
''')
        assert [a.name for a in acts] == ["description", "wait",
                                          "check-last-sample"]
        assert acts[0].fields["summary"] == "sanity check"
        assert acts[0].fields["seek"] is False
        assert acts[1].fields["duration"] == 0.5
        return [(a.name, a.fields) for a in acts]
    _both(body)


def test_scenario_check_last_sample():
    def body(P):
        V = P.mod("utils.validate")
        p = P.parse_launch("audiotestsrc num-buffers=4 samplesperbuffer=64 "
                           "! appsink name=sink")
        p.set_state(P.State.PLAYING)
        p.run()
        want = hashlib.sha256(p.get_by_name("sink").samples[-1].to_bytes()
                              ).hexdigest()
        runner = V.ScenarioRunner(p, f'''
description, summary="post-run checks"
check-last-sample, sink-name=sink, checksum={want}
stop
''')
        assert runner.run(), runner.reports
        assert [r.level for r in runner.reports] == ["ok", "ok", "ok"]
        return want, _reports(P, runner)
    _both(body)


def test_scenario_checksum_mismatch_reports_error():
    def body(P):
        V = P.mod("utils.validate")
        p = P.parse_launch("audiotestsrc num-buffers=2 ! appsink name=sink")
        p.set_state(P.State.PLAYING)
        p.run()
        runner = V.ScenarioRunner(p, "check-last-sample, sink-name=sink, "
                                     "checksum=deadbeef")
        assert not runner.run()
        assert runner.reports[0].level == "error"
        assert "checksum" in runner.reports[0].message
        return _reports(P, runner)
    _both(body)


def test_scenario_unknown_action():
    def body(P):
        V = P.mod("utils.validate")
        p = P.parse_launch("audiotestsrc num-buffers=1 ! appsink name=sink")
        runner = V.ScenarioRunner(p, "frob-the-widgets, hard=true")
        assert not runner.run()
        assert "unknown action" in runner.reports[0].message
        return _reports(P, runner)
    _both(body)


def test_scenario_eos_and_position():
    def body(P):
        V = P.mod("utils.validate")
        p = P.parse_launch("audiotestsrc num-buffers=10 samplesperbuffer=441"
                           " ! appsink name=sink")
        runner = V.ScenarioRunner(p, '''
set-state, state=playing
eos
check-position, expected-position=0.09, tolerance=0.02
stop
''')
        assert runner.run(), [r.message for r in runner.reports]
        return _reports(P, runner)
    _both(body)


def test_check_last_frame_qrcode_env_gated_skip():
    def body(P):
        V = P.mod("utils.validate")
        p = P.parse_launch("videotestsrc num-buffers=1 ! appsink name=sink")
        p.set_state(P.State.PLAYING)
        p.run()
        V.QR_DECODER = None
        runner = V.ScenarioRunner(p, "check-last-frame-qrcode, "
                                     "sink-name=sink")
        assert runner.run()
        assert runner.reports[0].level == "skipped"
        return _reports(P, runner)
    _both(body)


def test_check_last_frame_qrcode_with_injected_decoder():
    def body(P):
        V = P.mod("utils.validate")
        p = P.parse_launch("videotestsrc num-buffers=1 ! capsfilter caps="
                           "\"video/x-raw, format=RGB, width=16, height=16\""
                           " ! appsink name=sink")
        p.set_state(P.State.PLAYING)
        p.run()
        frames = []
        payload = json.dumps({"TIMESTAMP": 42, "name": "cam1"})

        def decoder(frame):
            frames.append(np.asarray(frame).tobytes())
            return [payload]
        V.QR_DECODER = decoder
        try:
            runner = V.ScenarioRunner(p, '''
check-last-frame-qrcode, sink-name=sink, expected-fields="{\\"TIMESTAMP\\": 42}"
''')
            assert runner.run(), [r.message for r in runner.reports]
            runner2 = V.ScenarioRunner(p, '''
check-last-frame-qrcode, sink-name=sink, expected-fields="{\\"TIMESTAMP\\": 7}"
''')
            assert not runner2.run()
        finally:
            V.QR_DECODER = None
        return _reports(P, runner), _reports(P, runner2), frames
    _both(body)


def test_fmt_tracer(caplog):
    def body(P):
        t = P.mod("utils.tracing").FmtTracer(level="INFO")
        t.install()
        caplog.clear()
        try:
            with caplog.at_level(logging.INFO, logger=f"{P.name}.trace"):
                p = P.parse_launch("audiotestsrc num-buffers=2 ! "
                                   "appsink name=sink")
                p.set_state(P.State.PLAYING)
                p.run()
            lines = [r.getMessage() for r in caplog.records
                     if r.name == f"{P.name}.trace"]
            assert any("pad_push" in m for m in lines)
        finally:
            t.uninstall()
        # the push times differ from run to run
        return [re.sub(r" [\d.]+us$", "", _neutral(P, m)) for m in lines]
    _both(body)


# ---------------------------------------------------------------------------
# the launch tool as chip_smoke.py's phase 16d runs it
# ---------------------------------------------------------------------------

def test_phase16_launch_tool(tmp_path):
    """`python -m gstpu_torch.tools.launch` on 4 frames of the grade at
    64x48: with `--device cpu` it exits 0; with no --device it asks for
    the card, and on a machine without one exits non-zero with
    core/device.py's error instead of running on the CPU; the card is
    hidden from that run, so the test checks the same on every machine.
    `python -m gstpu_torch.tools.inspect --device cpu intersrc` exits 0."""
    cube = tmp_path / "g.cube"
    chip_smoke.write_cube(cube, np.random.default_rng(16), n=9)
    src, grade = chip_smoke.grade_strings(
        64, 48, chip_smoke.PLUMBING_LAUNCH_FRAMES, cube)
    launch = [sys.executable, "-m", "gstpu_torch.tools.launch", "-q",
              f"{src} ! {grade} ! fakesink"]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    runs = {"cpu": launch + ["--device", "cpu"], "default": launch,
            "inspect": [sys.executable, "-m", "gstpu_torch.tools.inspect",
                        "--device", "cpu", "intersrc"]}
    envs = {"default": dict(env, CUDA_VISIBLE_DEVICES="")}
    procs = {k: subprocess.Popen(cmd, cwd=ROOT, env=envs.get(k, env),
                                 text=True, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE)
             for k, cmd in runs.items()}
    res = {k: (p.communicate(timeout=120), p.returncode)
           for k, p in procs.items()}
    (_, err), rc = res["cpu"]
    assert rc == 0, err
    (_, err), rc = res["default"]
    assert rc != 0 and "CUDA device requested" in err, err
    (out, err), rc = res["inspect"]
    assert rc == 0 and "Name          intersrc" in out, err
