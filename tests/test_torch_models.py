"""The port's model elements and its docs cache against gstpu's, on the
CPU: demucs, whispertranscriber, llamatexttransform and
`python -m gstpu_torch.tools.docs_cache`.

Twins of all of tests/test_demucs.py and test_whisper.py (the real
Whisper case slow, as gstpu's is) and of
test_viuer_compositor_llm.py:100,128, each gstpu test run as gstpu's and
as the port's through test_torch_webrtc.twin. The models are the tests'
own, made locally (a scripted separator, a random Whisper and GPT-2 with
synthetic byte vocabularies): nothing is downloaded.

Then, for each model element, its model and the tensors fed to it lie on
the CPU where the port is initialised there, and its output bytes equal
gstpu's on the same inputs, through chip_smoke.py's phase 20 helpers:
demucs with chip_smoke.StemSeparator, Whisper at small widths through
`whisper_model_dir`, the tests' GPT-2 through `gpt2_model_dir`. Last,
the port's checked-in docs cache against a fresh one and against
gstpu's, and the one place where the port's demucs departs from gstpu's.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
import gstpu
import gstpu_torch
from test_torch_net import _as_port
from test_torch_webrtc import TESTS, _both_on_cpu, case, twin  # noqa: F401
from torch_session import torch_test_limit  # noqa: F401

ROOT = TESTS.parent
NAMES = ("gstpu", "gstpu_torch")
PORT_CACHE = ROOT / "docs" / "plugins" / "gstpu_torch_plugins_cache.json"
GSTPU_CACHE = ROOT / "docs" / "plugins" / "gstpu_plugins_cache.json"


def _twins(*cases):
    return pytest.mark.parametrize("module,test,vary", cases)


@_twins(
    case("test_demucs", "test_demucs_stems", path="model_path"),
    case("test_demucs", "test_demucs_missing_weights_errors"),
    case("test_whisper", "test_chunked_transcription_with_injected_engine"),
    case("test_whisper", "test_missing_model_path_errors"),
    pytest.param(*case("test_whisper",
                       "test_real_transformers_whisper_tiny_random",
                       path="d vdir").values,
                 marks=pytest.mark.slow,
                 id="test_whisper::test_real_transformers_whisper_tiny_random"),
    case("test_viuer_compositor_llm",
         "test_llamatexttransform_with_injected_engine"),
    case("test_viuer_compositor_llm",
         "test_llamatexttransform_real_transformers", path="vdir"))
def test_models_twin(module, test, vary, tmp_path):
    twin(module, test, tmp_path, vary)


# ---------------------------------------------------------------------------
# each model element on the CPU: where its model and inputs lie, and its
# bytes against gstpu's
# ---------------------------------------------------------------------------

class _InputDevices:
    """While the `with` block runs, the device types of the tensors each
    `torch.nn.Module.__call__` of a module named in `names` is given."""

    def __init__(self, *names):
        self.names, self.seen = names, set()

    def __enter__(self):
        self._call = call = torch.nn.Module.__call__
        names, seen = self.names, self.seen

        def spy(module, *args, **kw):
            if type(module).__name__ in names:
                seen.update(a.device.type for a in (*args, *kw.values())
                            if isinstance(a, torch.Tensor))
            return call(module, *args, **kw)
        torch.nn.Module.__call__ = spy
        return self

    def __exit__(self, *exc):
        torch.nn.Module.__call__ = self._call


def _stems(pkg, model, x):
    """`appsrc ! demucs` in `pkg` on the CPU, its four stems linked: each
    stem's bytes and buffer times, and the element."""
    caps = "audio/x-raw, format=F32LE, rate=44100, channels=2, " \
           "layout=interleaved"

    def build(p):
        make = __import__(f"{pkg.__name__}.core.registry",
                          fromlist=["make"]).make
        sep = p.get_by_name("sep")
        for stem in chip_smoke.SEPARATE_STEMS:
            sink = make("appsink", stem)
            p.add(sink)
            sep.request_pad(f"src_{stem}").link(sink.static_pad("sink"))

    def feed(p):
        src = p.get_by_name("src")
        for i in range(0, len(x), 4410):
            src.push_buffer(pkg.Buffer(x[i:i + 4410].copy(),
                                       pts=i * 10 ** 9 // 44100))
        src.end_of_stream()
    p, _, out, _ = chip_smoke.run_string(
        pkg, "cpu", f'appsrc name=src caps="{caps}" ! demucs name=sep '
        f'model-location={model} segment=0.25', chip_smoke.SEPARATE_STEMS,
        feed, build)
    return {s: [(b.to_bytes(), b.pts, b.duration) for b in out[s]]
            for s in chip_smoke.SEPARATE_STEMS}, p.get_by_name("sep")


def test_demucs_on_cpu(tmp_path):
    """With the port on the CPU, demucs loads chip_smoke's StemSeparator
    onto the CPU and feeds it CPU tensors; 0.6 s of seeded stereo in
    0.25 s segments (the last one short) comes out of each stem pad as
    gstpu's bytes, with gstpu's times."""
    model = chip_smoke.separator_file(tmp_path / "sep.pt")
    x = np.random.default_rng(16).uniform(-0.5, 0.5, (26460, 2)) \
        .astype(np.float32)
    ref, _ = _stems(_as_port("gstpu"), model, x)
    with _InputDevices("RecursiveScriptModule") as seen:
        port, sep = _stems(gstpu_torch, model, x)
    assert chip_smoke.model_devices(sep._model) == {"cpu"}
    assert seen.seen == {"cpu"}
    assert port == ref
    assert [len(v) for v in port.values()] == [3] * 4


def test_demucs_follows_a_transform(tmp_path):
    """The port's departure (ROADMAP Queue C, Deliberate): its demucs
    pads take one or two channels as a range, so phase 20a's
    `audioconvert ! audioresample` string negotiates with it and its
    stems are those of `appsrc ! demucs` fed the resampled audio. gstpu's
    pads carry a plain tuple (1, 2), which intersects with no other caps:
    gstpu cannot link audioconvert to demucs."""
    model = chip_smoke.separator_file(tmp_path / "sep.pt")
    res = chip_smoke.separate(gstpu_torch, "cpu", model, 0.25)
    run = chip_smoke.run_string(
        gstpu_torch, "cpu", chip_smoke.separate_string(model).split(
            " ! demucs")[0] + " ! appsink name=out", ("out",),
        chip_smoke.feed_blocks(gstpu_torch, chip_smoke.edge_signal(
            0.25, chip_smoke.RATE_192K).astype(np.float64) / 32768.0,
            chip_smoke.RATE_192K))
    x = np.concatenate([np.frombuffer(b.to_bytes(), np.float32)
                        for b in run[2]["out"]]).reshape(-1, 2)
    direct, _ = _stems(gstpu_torch, model, x)
    assert len(x) == 11023
    for stem in chip_smoke.SEPARATE_STEMS:
        got = b"".join(b for b, _, _ in direct[stem])
        assert res["stems"][stem].tobytes() == got
    gstpu.init()
    with pytest.raises(RuntimeError, match="template caps do not intersect"):
        gstpu.parse_launch(f"audiotestsrc ! audioconvert ! demucs "
                           f"model-location={model}")


def _whisper(tmp_path):
    pytest.importorskip("transformers")
    return chip_smoke.whisper_model_dir(tmp_path / "w", 32, 1, 2, 64)


def test_whisper_on_cpu(tmp_path):
    """With the port on the CPU, whispertranscriber loads a random
    Whisper (chip_smoke.whisper_model_dir at d_model 32) onto the CPU
    and feeds its encoder CPU features; phase 20b's string (1 s of the
    telephony leg at 16 kHz mono F32) gives gstpu's texts, and the
    encoder's last hidden state and every decoding step's logits equal
    gstpu's bit for bit."""
    model = _whisper(tmp_path)
    ref = chip_smoke.transcribe(_as_port("gstpu"), "cpu", model)
    with _InputDevices("WhisperEncoder", "WhisperDecoder") as seen:
        port = chip_smoke.transcribe(gstpu_torch, "cpu", model)
    assert chip_smoke.model_devices(port["model"]) == {"cpu"}
    assert seen.seen == {"cpu"}
    assert port["texts"] == ref["texts"]
    assert torch.equal(port["encoder"], ref["encoder"])
    assert port["encoder"].shape == (1, 1500, 32)
    assert len(port["logits"]) == len(ref["logits"]) > 0
    assert all(torch.equal(a, b)
               for a, b in zip(port["logits"], ref["logits"]))
    assert chip_smoke.first_divergence(port["logits"], ref["logits"]) is None


def test_llm_on_cpu(tmp_path):
    """With the port on the CPU, llamatexttransform loads the tests'
    GPT-2 (chip_smoke.gpt2_model_dir) onto the CPU and feeds it CPU token
    ids; phase 20c's prompts give gstpu's replies and every step's logits
    bit for bit, greedy and sampled (temp 0.8, seed 5: torch.manual_seed
    makes the port draw as gstpu does)."""
    pytest.importorskip("transformers")
    model = chip_smoke.gpt2_model_dir(tmp_path / "lm")
    ref = chip_smoke.rewrite(_as_port("gstpu"), "cpu", model)
    with _InputDevices("GPT2LMHeadModel") as seen:
        port = chip_smoke.rewrite(gstpu_torch, "cpu", model)
    assert chip_smoke.model_devices(port["model"]) == {"cpu"}
    assert seen.seen == {"cpu"}
    assert port["texts"] == ref["texts"] and len(port["texts"]) == 2
    assert all(torch.equal(a, b)
               for a, b in zip(port["logits"], ref["logits"]))
    replies = {}
    for pkg in (_as_port("gstpu"), gstpu_torch):
        pkg.init(device="cpu")
        p = pkg.parse_launch(
            'appsrc name=src caps="text/x-raw, format=utf8" ! '
            f'llamatexttransform model-path={model} temp=0.8 seed=5 '
            'max-tokens=12 ! appsink name=out')
        p.set_state(pkg.State.PLAYING)
        p.get_by_name("src").push_buffer(pkg.Buffer(b"GRADED", pts=0))
        p.get_by_name("src").end_of_stream()
        p.run(timeout=120)
        replies[pkg.__name__] = [b.to_bytes()
                                 for b in p.get_by_name("out").pull_all()]
        p.set_state(pkg.State.NULL)
    assert replies["gstpu"] == replies["gstpu_torch"]
    assert replies["gstpu"] != [b""]


# ---------------------------------------------------------------------------
# the docs cache (tests/test_tools.py:49 for the port's own file)
# ---------------------------------------------------------------------------

def test_docs_cache_current(tmp_path):
    """The port's checked-in docs cache matches a fresh regeneration by
    `python -m gstpu_torch.tools.docs_cache`, run in a subprocess (earlier
    tests may have registered mock elements in this interpreter's
    registry); it lists the port's 268 factories and needs no card."""
    out = tmp_path / "cache.json"
    r = subprocess.run(
        [sys.executable, "-m", "gstpu_torch.tools.docs_cache", "-o",
         str(out)], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == f"wrote {out} (268 elements)"
    fresh = out.read_text()
    assert PORT_CACHE.read_text() == fresh, \
        "docs cache stale: run python -m gstpu_torch.tools.docs_cache"
    cache = json.loads(fresh)
    assert len(cache) == 268
    echo = cache["rsaudioecho"]
    assert echo["pad_templates"][0]["direction"] in ("sink", "src")
    assert "delay" in echo["properties"]
    assert echo["impl"] == "gstpu_torch.elements.audio.audiofx.AudioEcho"


# Each (element, field) where the port's checked-in cache differs from
# gstpu's once `impl`'s `gstpu.` prefix reads `gstpu_torch.`, and why.
CACHE_DEPARTURES = {
    ("audiornnoise", "properties"):
        "the blurbs of `context`, `precision` and `engine` name the port's "
        "device and host engine, not the TPU",
    ("colorlut", "properties"):
        "the `context` blurb says a batched frame step, not a dispatch",
    ("hsvfilter", "properties"):
        "the `context` blurb says a batched frame step and drops SURVEY's "
        "layer name",
    ("rsaudioecho", "properties"):
        "the `context` blurb says one batched step per block round",
    ("rav1enc", "properties"):
        "the `rc_mode` and `device_transform` blurbs say device, not TPU",
    ("ffv1enc", "description"):
        "its engine is the device-split one, not the TPU-split one",
    ("yoloxinference", "description"):
        "it runs the torch YOLOX forward of gstpu_torch/ops/yolox.py",
    ("burn-yoloxinference", "impl"):
        "the port's analytics module registers it as a subclass of its own "
        "(gstpu's aliases module makes it)",
    ("burn-yoloxinference", "description"):
        "the port's subclass has a docstring; gstpu's alias has none",
    ("llamatexttransform", "properties"):
        "the port adds `context`: the prompts of a DeviceContext's members "
        "run as one batched prefill and decode of the port's own "
        "deepseek_v3 model (gstpu has no such model)",
    ("llamacpp-texttransform", "properties"):
        "the alias of llamatexttransform, with its `context`",
    ("demucs", "pad_templates"):
        "the port's pads take channels as the range [1,2] (gstpu's plain "
        "tuple (1, 2) intersects with no other caps; "
        "test_demucs_follows_a_transform)",
}


def test_docs_cache_against_gstpus():
    """The port's checked-in docs cache documents gstpu's 268 factories
    as gstpu's checked-in cache does, each field equal once `impl` reads
    `gstpu_torch.` for `gstpu.`, but the (element, field) pairs in
    CACHE_DEPARTURES, each for its reason."""
    port = json.loads(PORT_CACHE.read_text())
    ref = json.loads(GSTPU_CACHE.read_text())
    assert set(port) == set(ref) and len(port) == 268
    differ = set()
    for name, entry in ref.items():
        entry = dict(entry, impl="gstpu_torch." + entry["impl"]
                     .removeprefix("gstpu."))
        assert set(entry) == set(port[name])
        differ |= {(name, f) for f in entry if entry[f] != port[name][f]}
    assert differ == set(CACHE_DEPARTURES)
    assert all(CACHE_DEPARTURES.values())
    demucs = [t["caps"] for t in port["demucs"]["pad_templates"]]
    assert all("channels=[1,2]" in c for c in demucs), demucs
