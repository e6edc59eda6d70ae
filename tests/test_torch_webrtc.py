"""The port's WebRTC media plane against gstpu's, on the CPU: STUN, ICE,
TURN, SCTP data channels, DTLS-SRTP, TWCC, ULPFEC and RTX.

Twins of all of tests/test_ice.py, test_sctp.py, test_stun_srflx.py,
test_turn.py, test_twcc.py, test_ulpfec.py and test_rtx.py, and of
test_dtls.py:107,133,192. Each twin runs the gstpu test as it stands
twice: once as gstpu's, and once from a copy of its module whose every
`gstpu` import, at the top and inside the functions, resolves to the
port (`shadow`), so that the port meets each of gstpu's assertions on the
same inputs. What the test's body saw (its locals when it returns:
bytes, numbers, strings, buffers, dataclasses, containers of them) must
then be equal in both packages, except the names a twin lists in
`vary`, each for a reason in REASONS: ICE credentials, transaction IDs,
DTLS randoms, keys and certificates come from `os.urandom`, ports from
the kernel, and times from the wall clock. The payloaders' RFC 3550
draws are seeded alike, so RTP compares byte for byte.

Then the wire across packages (gstpu's webrtcsink into the port's
webrtcsrc over a live signalling server, and the reverse), phase 19's
legs of `chip_smoke.py` at 64x48 in both packages, a TWCC feedback
sequence built from the same arrivals in both, and two behaviours of
gstpu's that the port keeps, pinned in both (ROADMAP Queue C). Each
wire and phase test waits on chip_smoke.wait_for, whose deadline only a
fault reaches; a twin keeps its gstpu test's own deadlines.
"""

import builtins
import dataclasses
import enum
import functools
import importlib
import inspect
import re
import sys
import threading
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
import gstpu
import gstpu_torch
from test_torch_rtp import _SeededRandom
from torch_session import torch_test_limit  # noqa: F401

TESTS = Path(__file__).resolve().parent
W, H = 64, 48

# why a twin may leave a local out of the comparison
REASONS = {
    "random": "drawn from os.urandom or secrets in both packages (ICE "
              "credentials, STUN transaction IDs, DTLS randoms and keys, "
              "certificates, session and resource IDs), or bytes that "
              "carry such a value",
    "port": "a socket's port, which the kernel picks",
    "clock": "read from the wall or monotonic clock, or a value that "
             "carries such a time (a TWCC reference time, an NTP stamp)",
    "path": "a path under each package's own tmp_path",
}


@pytest.fixture(autouse=True)
def _both_on_cpu():
    """gstpu's registry and the port's, the port on the CPU."""
    gstpu.init()
    gstpu_torch.init(device="cpu")


class _PortPackage(types.ModuleType):
    """gstpu_torch under gstpu's name, its init() on the CPU: what a gstpu
    test gets for `import gstpu`."""

    def __getattr__(self, name):
        return getattr(gstpu_torch, name)


_PORT = _PortPackage("gstpu")
_PORT.init = lambda *a, **k: gstpu_torch.init(device="cpu")


def _port_import(name, globals=None, locals=None, fromlist=(), level=0):
    """__import__ with `gstpu` and its submodules resolved to the port."""
    if level == 0 and (name == "gstpu" or name.startswith("gstpu.")):
        mod = builtins.__import__("gstpu_torch" + name[len("gstpu"):],
                                  globals, locals, fromlist, level)
        return mod if fromlist and name != "gstpu" else _PORT
    return builtins.__import__(name, globals, locals, fromlist, level)


@functools.cache
def shadow(name: str) -> types.ModuleType:
    """gstpu's tests/<name>.py loaded afresh, every `gstpu` import it
    makes resolved to the port: its tests then run the port."""
    path = TESTS / f"{name}.py"
    mod = types.ModuleType(f"port_{name}")
    mod.__file__ = str(path)
    mod.__builtins__ = dict(vars(builtins), __import__=_port_import)
    exec(compile(path.read_text(), str(path), "exec"), vars(mod))
    return mod


def reference(name: str) -> types.ModuleType:
    """gstpu's tests/<name>.py as it is."""
    return importlib.import_module(name)


def _locals_at_return(fn, kwargs) -> dict:
    """Call `fn(**kwargs)` and return its frame's locals as it returns
    (a trace on that one frame; calls it makes are not traced)."""
    code, seen = fn.__code__, {}

    def local(frame, event, arg):
        if event == "return":
            seen.update(frame.f_locals)
        return local

    def calls(frame, event, arg):
        if frame.f_code is code:
            frame.f_trace_lines = False
            return local
        return None
    old = sys.gettrace()
    sys.settrace(calls)
    try:
        fn(**kwargs)
    finally:
        sys.settrace(old)
    return seen


# what `plain` masks in every string: the random and kernel-picked
# fields of an SDP or a URI (REASONS "random" and "port")
MASKS = [(re.compile(p), r) for p, r in (
    (r"(a=ice-ufrag:)\S+", r"\1*"), (r"(a=ice-pwd:)\S+", r"\1*"),
    (r"(a=fingerprint:sha-256 )[0-9A-F:]+", r"\1*"),
    (r"(a=candidate:)\S+( \d+ udp \d+ \S+ )\d+", r"\1*\2*"),
    (r"(127\.0\.0\.1:)\d+", r"\1*"))]


def mask(text: str) -> str:
    for pattern, repl in MASKS:
        text = pattern.sub(repl, text)
    return text


class _Skip:
    """A value a twin does not compare (elements, sockets, functions)."""


SKIP = _Skip()


def plain(v, depth: int = 0):
    """`v` with the package taken out: strings masked (MASKS), buffers as
    their bytes, pts and
    duration, enums by name, dataclasses by class name and fields, arrays
    and tensors by dtype, shape and bytes, containers element by element;
    SKIP for whatever else (an element, a socket, a function)."""
    if depth > 8:
        return SKIP
    if isinstance(v, str):
        return mask(v)
    if v is None or isinstance(v, (bool, int, float)):
        return v
    if isinstance(v, (bytes, bytearray, memoryview)):
        return bytes(v)
    if isinstance(v, enum.Enum):
        return (type(v).__name__, v.name)
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    if isinstance(v, np.ndarray):
        return ("ndarray", v.dtype.str, v.shape, v.tobytes())
    if isinstance(v, np.generic):
        return v.item()
    cls = type(v)
    mod = cls.__module__.split(".")[0]
    if mod in ("gstpu", "gstpu_torch"):
        if cls.__name__ == "Buffer":
            return ("Buffer", v.to_bytes(), v.pts, v.duration)
        if cls.__name__ == "Caps":
            return ("Caps", str(v))
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (cls.__name__, {f.name: plain(getattr(v, f.name), depth + 1)
                               for f in dataclasses.fields(v)})
    if isinstance(v, dict):
        return {plain(k, depth + 1): plain(x, depth + 1)
                for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(plain(x, depth + 1) for x in v)
    if isinstance(v, (set, frozenset)):
        return ("set", sorted((plain(x, depth + 1) for x in v), key=repr))
    return SKIP


def _strip(v):
    """`plain`'s result with every SKIP left out, so that two of them
    compare with ==."""
    if isinstance(v, _Skip):
        return "<skipped>"
    if isinstance(v, dict):
        return {k: _strip(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_strip(x) for x in v)
    return v


def _raw(fixture):
    """The function under a module's pytest fixture."""
    return fixture._get_wrapped_function()


def _skip_marks(fn) -> None:
    """Skip as pytest would for the test's own skipif marks."""
    for mark in getattr(fn, "pytestmark", []):
        if mark.name == "skipif" and mark.args and mark.args[0]:
            pytest.skip(mark.kwargs.get("reason", "skipif"))


def _end_signalling_readers(before: set) -> None:
    """Stop the signalling clients started since `before` (webrtcsrc's
    NULL leaves its own running, ROADMAP Queue C) and wait until their
    reader threads have ended. gstpu's client closes its socket under a
    reader that may still be inside a read, and a TLS read goes to the
    descriptor's number: left running, that reader could take the bytes
    of the next half's socket opened under the same number."""
    for t in set(threading.enumerate()) - before:
        target = getattr(t, "_target", None)
        if getattr(target, "__qualname__", "") == "SignallingClient._run":
            target.__self__.stop()
            t.join(timeout=5.0)


def _call(mod, package: str, test: str, tmp: Path) -> dict:
    """Run `mod`'s test `test` on `package`, its arguments from `mod`'s
    own fixtures, `tmp_path` (`tmp`) and `monkeypatch`, the payloaders'
    random draws (RFC 3550's SSRC, first sequence number and timestamp)
    seeded alike for both packages; the locals it returns with. The
    signalling clients it started have ended when it returns."""
    fn = getattr(mod, test)
    _skip_marks(fn)
    tmp.mkdir(parents=True, exist_ok=True)
    before = set(threading.enumerate())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(f"{package}.net.rtp.basepay.random", _SeededRandom())
        built: dict = {"tmp_path": tmp, "monkeypatch": mp}
        finalizers = []

        def resolve(name):
            if name not in built:
                fix = _raw(getattr(mod, name))
                args = {p: resolve(p)
                        for p in inspect.signature(fix).parameters}
                value = fix(**args)
                if inspect.isgenerator(value):
                    finalizers.append(value)
                    value = next(value)
                built[name] = value
            return built[name]
        try:
            kwargs = {p: resolve(p)
                      for p in inspect.signature(fn).parameters}
            seen = _locals_at_return(fn, kwargs)
            # pytest's assertion rewriting adds its own
            return {k: v for k, v in seen.items() if not k.startswith("@")}
        finally:
            for gen in reversed(finalizers):
                next(gen, None)
            _end_signalling_readers(before)


def twin(module: str, test: str, tmp_path: Path, vary=()) -> dict:
    """gstpu's `module`::`test` run as gstpu's and as the port's: both
    pass its assertions, and what its body saw is equal in both but the
    names in `vary`. Returns the port's locals."""
    ref = _call(reference(module), "gstpu", test, tmp_path / "gstpu")
    port = _call(shadow(module), "gstpu_torch", test,
                 tmp_path / "gstpu_torch")
    assert set(ref) == set(port)
    seen = {k: (_strip(plain(ref[k])), _strip(plain(port[k])))
            for k in ref if k not in vary}
    differ = sorted(k for k, (a, b) in seen.items() if a != b)
    assert not differ, {k: seen[k] for k in differ}
    return port


def case(module: str, test: str, **why):
    """A parametrize entry: gstpu's `module`::`test`, with each name a
    twin does not compare under its reason (a key of REASONS)."""
    vary = tuple(n for names in why.values() for n in names.split())
    assert set(why) <= set(REASONS)
    return pytest.param(module, test, vary, id=f"{module}::{test}")


def _twins(*cases):
    return pytest.mark.parametrize("module,test,vary", cases)


# ---------------------------------------------------------------------------
# STUN and ICE (tests/test_ice.py, tests/test_stun_srflx.py)
# ---------------------------------------------------------------------------

@_twins(
    case("test_ice", "test_stun_roundtrip_with_integrity_and_fingerprint",
         random="bad data msg parsed"),
    case("test_ice", "test_xor_mapped_address_roundtrip"),
    case("test_ice", "test_candidate_sdp_roundtrip"),
    case("test_ice", "test_ice_full_vs_lite_connectivity"),
    case("test_ice", "test_ice_rejects_wrong_password"),
    case("test_ice", "test_ice_peer_reflexive_learning", random="data"),
    case("test_ice", "test_non_stun_passthrough"),
    case("test_stun_srflx", "test_gather_srflx_roundtrip", port="cand"),
    case("test_stun_srflx", "test_gather_srflx_timeout_returns_none"),
    case("test_stun_srflx", "test_webrtcsink_offers_srflx_candidate"))
def test_ice_twin(module, test, vary, tmp_path):
    twin(module, test, tmp_path, vary)


# ---------------------------------------------------------------------------
# TURN (tests/test_turn.py, its stand-in TURN server in each package)
# ---------------------------------------------------------------------------

@_twins(
    case("test_turn", "test_parse_turn_uri"),
    case("test_turn", "test_allocate_with_auth_dance", port="relayed"),
    case("test_turn", "test_allocate_rejects_bad_password"),
    case("test_turn", "test_relay_data_both_directions", port="got src",
         random="pkt"),
    case("test_turn", "test_refresh_survives_stale_nonce"),
    case("test_turn", "test_webrtcsink_offers_relay_candidate",
         port="rport"),
    case("test_turn", "test_webrtcsink_warns_on_dead_turn_server",
         port="port"),
    case("test_turn", "test_turn_servers_list_gathers_multiple_relays",
         port="relays sdp_lines"))
def test_turn_twin(module, test, vary, tmp_path):
    twin(module, test, tmp_path, vary)


# ---------------------------------------------------------------------------
# SCTP data channels (tests/test_sctp.py)
# ---------------------------------------------------------------------------

@_twins(
    case("test_sctp", "test_crc32c_vector"),
    case("test_sctp", "test_association_and_channel"),
    case("test_sctp", "test_large_message_fragments_and_reassembles"),
    case("test_sctp", "test_corrupt_packet_rejected", random="pkt"),
    case("test_sctp", "test_send_before_open_raises"),
    case("test_sctp", "test_data_channels_over_dtls_transport"),
    case("test_sctp", "test_spoofed_vtag_discarded"),
    case("test_sctp", "test_retransmit_on_timeout_after_loss",
         random="lost"),
    case("test_sctp", "test_fragment_loss_no_corruption", random="first"),
    case("test_sctp", "test_tsn_wraparound"),
    case("test_sctp", "test_serial_arithmetic"))
def test_sctp_twin(module, test, vary, tmp_path):
    twin(module, test, tmp_path, vary)


# ---------------------------------------------------------------------------
# DTLS-SRTP into the transport and the elements (tests/test_dtls.py:107,
# 133, 192; its DTLS-only cases are twinned in test_torch_quic.py)
# ---------------------------------------------------------------------------

@_twins(
    case("test_dtls", "test_srtp_keys_drive_webrtcsend_recv",
         random="key salt rkey rsalt protected"),
    case("test_dtls", "test_webrtc_transport_full_chain",
         random="da db data"),
    case("test_dtls", "test_webrtcsink_to_webrtcsrc_full_loop",
         clock="deadline"))
def test_dtls_twin(module, test, vary, tmp_path):
    twin(module, test, tmp_path, vary)


# ---------------------------------------------------------------------------
# TWCC, ULPFEC and RTX (tests/test_twcc.py, test_ulpfec.py, test_rtx.py)
# ---------------------------------------------------------------------------

@_twins(
    case("test_twcc", "test_feedback_roundtrip_contiguous"),
    case("test_twcc", "test_feedback_with_losses_and_reorder"),
    case("test_twcc", "test_large_negative_delta_uses_s16"),
    case("test_twcc", "test_sender_feedback_drives_gcc"),
    case("test_twcc", "test_parse_rejects_garbage"),
    case("test_twcc", "test_run_length_chunk_parses"),
    case("test_twcc", "test_live_webrtc_loop_carries_twcc",
         clock="deadline fb"),
    case("test_twcc", "test_twcc_flows_in_band_over_data_channel",
         clock="deadline"),
    case("test_twcc", "test_srtcp_roundtrip_and_replay",
         random="key salt prot bad"),
    case("test_twcc", "test_webrtcsink_stats_surface"),
    case("test_twcc", "test_webrtcsrc_jitterbuffer_reorders", clock="now"),
    case("test_twcc", "test_sender_reports_flow_over_srtcp",
         clock="deadline ntp"),
    case("test_twcc", "test_webrtcsrc_stats_surface"),
    case("test_ulpfec", "test_fec_recovers_each_single_loss"),
    case("test_ulpfec", "test_fec_window_striping"),
    case("test_ulpfec", "test_fec_decoder_pending_retry"),
    case("test_ulpfec", "test_red_roundtrip"),
    case("test_ulpfec", "test_lost_packet_recovered_via_fec_alone",
         clock="deadline"),
    case("test_rtx", "test_generic_nack_roundtrip"),
    case("test_rtx", "test_nack_blp_packing"),
    case("test_rtx", "test_rtx_unwrap"),
    case("test_rtx", "test_lost_packet_recovered_via_rtx",
         clock="deadline"))
def test_feedback_twin(module, test, vary, tmp_path):
    twin(module, test, tmp_path, vary)


def test_shadow_runs_the_port():
    """A shadow module's names, at its top and inside its functions, are
    the port's; gstpu's own module keeps gstpu's."""
    port, ref = shadow("test_dtls"), reference("test_dtls")
    assert port.DtlsEndpoint.__module__ == "gstpu_torch.net.webrtc.dtls"
    assert ref.DtlsEndpoint.__module__ == "gstpu.net.webrtc.dtls"
    seen = _locals_at_return(port.test_srtp_keys_drive_webrtcsend_recv, {})
    assert type(seen["tx"]).__module__ == "gstpu_torch.net.srtp"
    assert shadow("test_turn").T.__name__ == "gstpu_torch.net.webrtc.turn"
    assert _PORT.init is not gstpu_torch.init


# ---------------------------------------------------------------------------
# the wire across packages: one package's webrtcsink, the other's webrtcsrc
# ---------------------------------------------------------------------------

def _wire(send: str, recv: str) -> list:
    """`send`'s webrtcsink (its own signalling server) and `recv`'s
    webrtcsrc in a live session: listing, SDP, ICE, DTLS and SRTP across
    the two packages, as tests/test_live_signalling.py drives them. The
    A-law payloads that arrive depayloaded on `audio_0`, for five seeded
    160-byte buffers fed in."""
    S = {k: importlib.import_module(f"{send}.{k}")
         for k in ("core.registry", "core.element", "core.event",
                   "core.caps", "core.buffer")}
    R = {k: importlib.import_module(f"{recv}.{k}")
         for k in ("core.registry", "core.element", "core.caps")}
    el, ev = S["core.element"], S["core.event"]
    sink = S["core.registry"].make("webrtcsink", enable_data_transport=True,
                                   run_signalling_server=True)
    sink.bus = el.Bus()
    sink.set_state(el.State.PLAYING)
    src = None
    try:
        uri = None
        while (m := sink.bus.pop()) is not None:
            if m.fields.get("name") == "signalling-server-started":
                uri = m.fields["uri"]
        assert uri and uri.startswith("ws://127.0.0.1:")
        feeder = el.Pad("feed", el.PadDirection.SRC, el.PadTemplate(
            "src", el.PadDirection.SRC, el.PadPresence.ALWAYS,
            S["core.caps"].Caps.any()))
        feeder.link(sink.request_pad())
        feeder.push_event(ev.StreamStartEvent("a"))
        feeder.push_event(ev.CapsEvent(S["core.caps"].parse_caps(
            "audio/x-alaw, rate=8000, channels=1")))
        feeder.push_event(ev.SegmentEvent(ev.Segment()))
        core = sink._sig_server.core
        chip_smoke.wait_for(lambda: any(
            "producer" in p.roles for p in list(core._peers.values())),
            "the producer never registered")
        rel = R["core.element"]
        src = R["core.registry"].make("webrtcsrc",
                                      enable_data_transport=True,
                                      signaller_uri=uri)
        src.bus = rel.Bus()
        src.set_state(rel.State.PLAYING)
        chip_smoke.wait_for(lambda: bool(
            sink._transports and list(sink._transports.values())[0][0]
            .connected and src._transport is not None
            and src._transport.connected),
            "the session never connected", sink.pump, src.pump)
        media: list = []
        rng = np.random.default_rng(15)
        payloads = [rng.integers(0, 256, 160, dtype=np.uint8).tobytes()
                    for _ in range(5)]
        for i, data in enumerate(payloads):
            feeder.push(S["core.buffer"].Buffer(
                data, pts=i * 20_000_000, duration=20_000_000))
            if i == 0:
                chip_smoke.wait_for(lambda: "audio_0" in src.pads,
                                    "no audio_0 pad", sink.pump, src.pump)
                cap = rel.Pad("acap", rel.PadDirection.SINK,
                              rel.PadTemplate("sink", rel.PadDirection.SINK,
                                              rel.PadPresence.ALWAYS,
                                              R["core.caps"].Caps.any()))
                cap.chain_function = lambda p, b: (
                    media.append(b.to_bytes()) or rel.FlowReturn.OK)
                cap.event_function = lambda p, e: True
                src.pads["audio_0"].link(cap)
        chip_smoke.wait_for(lambda: len(media) >= 4, "the media never came",
                            sink.pump, src.pump)
        return media, payloads
    finally:
        if src is not None:
            src.set_state(src.state.__class__.NULL)
            if src._sig_client is not None:
                src._sig_client.stop()
        sink.set_state(sink.state.__class__.NULL)


@pytest.mark.parametrize("send,recv", [("gstpu", "gstpu_torch"),
                                       ("gstpu_torch", "gstpu")])
def test_webrtc_wire_across_packages(send, recv):
    """gstpu's webrtcsink into the port's webrtcsrc, and the reverse: the
    session connects over the sink's signalling server and the payloads
    fed after the first arrive, depayloaded, as they went in (the first
    one arrives before the typed pad is linked)."""
    media, payloads = _wire(send, recv)
    assert media == payloads[1:]


# ---------------------------------------------------------------------------
# phase 19 of chip_smoke.py at 64x48 in both packages
# ---------------------------------------------------------------------------

@pytest.fixture
def cube(tmp_path):
    path = tmp_path / "g.cube"
    chip_smoke.write_cube(path, np.random.default_rng(17), n=9)
    return path


def _direct(mod, n, cube):
    src, grade = chip_smoke.grade_strings(W, H, n, cube)
    return [b.to_bytes() for b in chip_smoke.run_string(
        mod, "cpu", f"{src} ! {grade} ! appsink name=out", ("out",))[2]["out"]]


def test_phase19_session():
    """19a at 0.5 s: in both packages the session connects over the
    sink's signalling server, every RTP packet arrives in order with no
    SRTP drop, the sink's GCC takes one TWCC report for each 16 packets
    and its estimate stays in its limits, and audio_0 carries what
    alawenc wrote; both packages deliver the same A-law bytes."""
    from test_torch_net import _as_port
    seen = {}
    for name in ("gstpu", "gstpu_torch"):
        res = chip_smoke.webrtc_phone(_as_port(name), "cpu", 0.5)
        assert res["sent"] == len(res["rtp"]) == 25
        assert res["lost"] == 0 and res["in_order"]
        assert res["auth_failures"] == 0
        assert len(res["twcc"]) == 1
        est, (lo, hi) = res["sink_stats"]["gcc-estimate"], res["limits"]
        assert lo <= est <= hi
        assert b"".join(res["out"]) == b"".join(res["head"])
        assert sum(map(len, res["out"])) == 4000
        assert res["server_stopped"]
        seen[name] = res["out"], [r[12:] for r in res["rtp"]]
    assert seen["gstpu"] == seen["gstpu_torch"]


def test_phase19_srtp(cube):
    """19b at 64x48: in both packages the frames that crossed SRTP keyed
    by a DTLS handshake are the direct string's, with no packet lost and
    no authentication failure; the port's payloader reads each frame once
    and neither webrtcsend nor webrtcrecv reads one."""
    from test_torch_net import _as_port
    n = chip_smoke.WEBRTC_FRAMES
    seen = {}
    for name in ("gstpu", "gstpu_torch"):
        mod = _as_port(name)
        want = _direct(mod, n, cube)
        with chip_smoke.ArrayCalls() as calls:
            res = chip_smoke.srtp_grade(mod, "cpu", W, H, n, cube)
        assert res["frames"] == want
        assert res["keys_equal"] and res["auth_failures"] == 0
        assert res["lost"] == 0 and res["in_order"]
        seen[name] = res["frames"], res["seqnums"], calls
    assert seen["gstpu"][:2] == seen["gstpu_torch"][:2]
    assert chip_smoke.new_reads(seen["gstpu_torch"][2], (
        "pay", "srtp", "udp", "src", "depay", "out")) == {"pay": n}


def test_phase19_whip_whep():
    """19c at 0.25 s: the WHIP server and each WHEP client get exactly
    the packets the payloader sent, and both packages send the same."""
    from test_torch_net import _as_port
    seen = {}
    for name in ("gstpu", "gstpu_torch"):
        mod = _as_port(name)
        whip = chip_smoke.whip_phone(mod, "cpu", 0.25)
        assert whip["got"] == whip["sent"] and len(whip["sent"]) == 13
        assert whip["status"] == (201, 200) and whip["pad_removed"]
        whep = chip_smoke.whep_phone(mod, "cpu", 0.25, 2)
        assert whep["got"] == [whep["sent"]] * 2
        assert whep["status"] == [201, 201]
        seen[name] = whip["got"], whep["got"]
    assert seen["gstpu"] == seen["gstpu_torch"]


def test_phase19_raw_video(cube):
    """19d at 64x48: both packages pick the same encoder, encode the same
    number of frames, and what webrtcsrc depayloads is what the encoder
    wrote, with no packet lost (the leg runs on the card only where the
    codec shim links)."""
    from test_torch_net import _as_port
    if importlib.import_module("gstpu_torch.native_codec").load() is None:
        pytest.skip("the codec shim does not link (no libavcodec)")
    n = chip_smoke.WEBRTC_VIDEO_FRAMES
    seen = {}
    for name in ("gstpu", "gstpu_torch"):
        res = chip_smoke.webrtc_video(_as_port(name), "cpu", W, H, n, cube)
        assert b"".join(res["out"]) == b"".join(res["encoded"])
        assert res["lost"] == 0 and res["auth_failures"] == 0
        assert res["encoded"]
        seen[name] = res["encoder"], len(res["encoded"])
    assert seen["gstpu"] == seen["gstpu_torch"]


def test_twcc_feedback_sequence_equal():
    """The live twins leave TWCC feedback out (its times are the wall
    clock's): fed the same seeded arrivals, with gaps and reordering,
    both packages' TwccReceivers build the same three packets in turn
    (feedback counts 0, 1, 2), and both TwccSenders turn them into the
    same PacketFeedback for GCC."""
    seen = {}
    for name in ("gstpu", "gstpu_torch"):
        twcc = importlib.import_module(f"{name}.net.rtp.twcc")
        rx, tx, t, out = twcc.TwccReceiver(), twcc.TwccSender(), 0, []
        rng = np.random.default_rng(19)
        for burst in range(3):
            seqs = [burst * 20 + i for i in range(20)
                    if rng.random() > 0.15]
            rng.shuffle(seqs)
            for seq in seqs:
                t += int(rng.integers(0, 60_000_000))
                tx._sent[seq] = (t - 5_000_000, 1200)
                rx.record(seq, t)
            fb = rx.build_feedback()
            out.append((fb, [(p.send_time, p.recv_time, p.size)
                             for p in tx.on_feedback(fb)]))
        assert [fb[19] for fb, _ in out] == [0, 1, 2]
        seen[name] = out
    assert seen["gstpu"] == seen["gstpu_torch"]


# ---------------------------------------------------------------------------
# gstpu's behaviour, kept in the port and pinned (ROADMAP Queue C)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["gstpu", "gstpu_torch"])
def test_twcc_gap_above_8s_raises(name):
    """A TWCC feedback packet carries an arrival delta in at most 16 bits
    of 250 us: both packages' TwccReceiver raise TwccError for two
    arrivals 9 s apart (webrtcsrc's pump lets it out), where the format
    would start a new feedback packet. 16 arrivals 20 ms apart pass."""
    twcc = importlib.import_module(f"{name}.net.rtp.twcc")
    rx = twcc.TwccReceiver()
    rx.record(0, 1_000_000_000)
    rx.record(1, 10_000_000_000)
    with pytest.raises(twcc.TwccError, match="delta out of range"):
        rx.build_feedback()
    rx = twcc.TwccReceiver()
    for i in range(16):
        rx.record(i, 1_000_000_000 + 20_000_000 * i)
    fb = rx.build_feedback()
    assert [s for s, _ in twcc.parse_feedback(fb)] == list(range(16))


@pytest.mark.parametrize("name", ["gstpu", "gstpu_torch"])
def test_webrtcsrc_null_keeps_its_signalling_client(name):
    """webrtcsrc defines `stop` twice and the second, which closes the
    media socket, hides the first, which stops the signalling client: in
    both packages a webrtcsrc set to NULL keeps its WebSocket to the
    server and its reader thread (chip_smoke.webrtc_session stops the
    client itself)."""
    reg = importlib.import_module(f"{name}.core.registry")
    el = importlib.import_module(f"{name}.core.element")
    sig = importlib.import_module(f"{name}.net.webrtc.signalling")
    server = sig.SignallingServer(port=0)
    server.start()
    try:
        src = reg.make("webrtcsrc", signaller_uri=f"ws://127.0.0.1:"
                       f"{server.port}")
        src.bus = el.Bus()
        src.set_state(el.State.PLAYING)
        client = src._sig_client
        assert client.connected.wait(60)
        src.set_state(el.State.NULL)
        assert src._sig_client is client and client._thread.is_alive()
        client.stop()
        client._thread.join(60)
        assert not client._thread.is_alive()
    finally:
        server.stop()
