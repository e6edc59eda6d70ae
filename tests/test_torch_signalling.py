"""The port's WebRTC signalling, WHIP/WHEP, SRTP, RoQ framing, the
network clock, the web server and the JS SDK's protocol against gstpu's,
on the CPU.

Twins of all of tests/test_signalling.py, test_live_signalling.py,
test_clock_signalling.py, test_webserver_tls.py and test_js_sdk.py, and
of test_tools.py:74 (the standalone signalling server). Each runs the
gstpu test as it stands as gstpu's and as the port's through
test_torch_webrtc.twin: both meet its assertions, and what its body saw
is equal but the names listed under a reason of REASONS. The JS SDK
(`gstpu/tools/gstwebrtc-api/`) is not code the port runs: its twins read
it where it is, and two of them skip as gstpu's do where the reference
SDK tree is absent. A standalone signalling server of the port runs as
`python -m gstpu_torch.tools.signalling_server`.
"""

import json
import subprocess
import sys
import time

import pytest

from test_torch_webrtc import _both_on_cpu, case, twin  # noqa: F401
from test_torch_webrtc import TESTS
from torch_session import torch_test_limit  # noqa: F401


def _twins(*cases):
    return pytest.mark.parametrize("module,test,vary", cases)


@_twins(
    case("test_signalling", "test_session_flow_sans_io"),
    case("test_signalling", "test_disconnect_ends_sessions"),
    case("test_signalling", "test_unknown_session_errors"),
    case("test_signalling", "test_websocket_server_end_to_end"),
    case("test_signalling", "test_whip_post_flow",
         random="resp sid patch dele"),
    case("test_signalling", "test_whip_redirect_repost", random="resp"),
    case("test_signalling", "test_whip_server_validation"),
    case("test_signalling", "test_whip_client_rejects_missing_location"),
    case("test_signalling", "test_whep_same_machine", random="resp"),
    case("test_signalling", "test_roq_varints"),
    case("test_signalling", "test_roq_datagram_and_stream"),
    case("test_signalling", "test_webrtcsink_full_session_flow"),
    case("test_signalling", "test_srtp_rfc3711_key_derivation_vectors"),
    case("test_signalling", "test_srtp_protect_roundtrip_and_tamper"),
    case("test_signalling", "test_srtp_forged_packet_does_not_poison_roc"),
    case("test_signalling", "test_webrtcsend_recv_pipeline"),
    case("test_signalling", "test_whip_elements_end_to_end",
         random="resp sid"),
    case("test_signalling", "test_whep_elements_fanout", random="resp sid"),
    case("test_signalling", "test_webrtcsink_to_webrtcsrc_session"),
    case("test_live_signalling",
         "test_standalone_session_over_live_signalling", clock="deadline"))
def test_signalling_twin(module, test, vary, tmp_path):
    twin(module, test, tmp_path, vary)


@_twins(
    case("test_clock_signalling", "test_ntp_clock_syncs_to_server_offset",
         clock="expect got"),
    case("test_clock_signalling", "test_ntp_clock_requires_live_server",
         port="port"),
    case("test_clock_signalling", "test_ntp_timestamp_roundtrip"),
    case("test_clock_signalling", "test_offer_signals_ntp_clock_rfc7273",
         clock="bt"),
    case("test_clock_signalling",
         "test_offer_signals_local_clock_without_provenance"),
    case("test_clock_signalling", "test_offer_has_no_clock_lines_by_default"),
    case("test_clock_signalling",
         "test_forward_metas_timecode_over_control_channel",
         clock="deadline"),
    case("test_clock_signalling", "test_control_channel_can_be_disabled"))
def test_clock_twin(module, test, vary, tmp_path):
    twin(module, test, tmp_path, vary)


@_twins(
    case("test_webserver_tls", "test_static_server_serves_directory",
         path="site"),
    case("test_webserver_tls", "test_static_server_mount_path", path="site"),
    case("test_webserver_tls", "test_static_server_tls",
         path="site pem_pair cert key"),
    case("test_webserver_tls", "test_webrtcsink_runs_web_server",
         path="site"),
    case("test_webserver_tls", "test_signalling_server_tls_loopback",
         path="pem_pair cert key"),
    case("test_tools", "test_signalling_server_binary_serves"))
def test_servers_twin(module, test, vary, tmp_path):
    twin(module, test, tmp_path, vary)


@_twins(
    case("test_js_sdk", "test_sdk_covers_protocol_vocabulary"),
    case("test_js_sdk", "test_sdk_module_structure_mirrors_reference"),
    case("test_js_sdk", "test_remote_controller_speaks_gst_navigation"),
    case("test_js_sdk", "test_consumer_session_handles_full_flow"),
    case("test_js_sdk", "test_consumer_flow_through_server"),
    case("test_js_sdk", "test_welcome_shape_matches_sdk_expectation"),
    case("test_js_sdk", "test_munge_stereo_copies_flag_per_payload"),
    case("test_js_sdk", "test_as_peer_normalization"),
    case("test_js_sdk", "test_keysym_dispatch"),
    case("test_js_sdk", "test_keysym_matches_reference_table"),
    case("test_js_sdk", "test_api_surface_matches_reference"))
def test_js_sdk_twin(module, test, vary, tmp_path):
    twin(module, test, tmp_path, vary)


def test_signalling_server_module_runs():
    """`python -m gstpu_torch.tools.signalling_server` serves the
    protocol: bound to port 0, it names its port, and a WebSocket client
    is welcomed with a peer id. The port's tool imports neither jax nor
    gstpu."""
    from gstpu_torch.net.ws import WsClient
    proc = subprocess.Popen(
        [sys.executable, "-m", "gstpu_torch.tools.signalling_server",
         "--host", "127.0.0.1", "--port", "0"],
        cwd=TESTS.parent, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    try:
        line = proc.stderr.readline()
        assert line.startswith("Listening on ws://127.0.0.1:"), line
        ws = WsClient(line.split()[-1], timeout=60)
        msg = json.loads(ws.recv(timeout=60))
        assert msg["type"] == "welcome" and msg["peerId"]
        ws.close()
    finally:
        proc.terminate()
        proc.wait(timeout=60)
    mods = subprocess.run(
        [sys.executable, "-c", "import sys, gstpu_torch.tools."
         "signalling_server; print(sorted(m for m in sys.modules if "
         "m.split('.')[0] in ('jax', 'gstpu')))"],
        cwd=TESTS.parent, capture_output=True, text=True, timeout=120)
    assert mods.stdout.strip() == "[]", mods.stderr


class _Producer:
    """The element side of a signalling client: registers as a producer."""

    def signalling_connect(self, welcome):
        return [{"type": "setPeerStatus", "roles": ["producer"],
                 "meta": {}}]

    def handle_signalling(self, msg):
        return []


def test_signalling_client_stop_ends_its_reader(tmp_path):
    """The port's one departure in signalling.py (ROADMAP Queue C,
    Deliberate): over wss://, `SignallingClient.stop` ends its reader
    thread at the reader's next poll, and only then sends the close
    frame and closes the socket; the server has dropped the peer. Three
    sessions in a row, each client's socket opened at once after the last
    one closed, so under the descriptor it freed.
    gstpu's stop closes the socket under a reader that may still be
    inside a read of it."""
    import ssl

    from cryptography.hazmat.primitives import serialization

    from gstpu_torch.net.webrtc.dtls import generate_certificate
    from gstpu_torch.net.webrtc.signalling import (SignallingClient,
                                                   SignallingServer)
    key, cert = generate_certificate("127.0.0.1")
    cp, kp = tmp_path / "cert.pem", tmp_path / "key.pem"
    cp.write_bytes(cert.public_bytes(serialization.Encoding.PEM))
    kp.write_bytes(key.private_bytes(
        serialization.Encoding.PEM, serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption()))
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.load_verify_locations(cp)
    ctx.check_hostname = False
    for _ in range(3):
        server = SignallingServer(cert=str(cp), key=str(kp))
        server.start()
        try:
            client = SignallingClient(f"wss://127.0.0.1:{server.port}",
                                      _Producer(), ssl_ctx=ctx)
            client.start()
            assert client.connected.wait(60)
            assert client._thread.is_alive() and server.core._peers
            client.stop()
            assert not client._thread.is_alive()
            assert client._ws is None
            deadline = time.monotonic() + 60
            while server.core._peers and time.monotonic() < deadline:
                time.sleep(0.01)
            assert not server.core._peers
        finally:
            server.stop()
