"""The port's cloud elements against gstpu's, on the CPU: S3, Polly,
Translate and Transcribe, Deepgram and Speechmatics, ElevenLabs.

Twins of all of tests/test_aws.py, test_cloudstt.py and
test_elevenlabs.py, each gstpu test run as gstpu's and as the port's
through test_torch_webrtc.twin: both meet its assertions, and what its
body saw is equal but the names listed under a reason of REASONS. The
stand-in S3, AI, Transcribe, speech-to-text and ElevenLabs servers are
the gstpu tests' own, on 127.0.0.1, loaded once for each package. The
presigned Transcribe URL a stand-in records carries the signing time and
the signature made with it, and the Deepgram request its WebSocket key.
Then chip_smoke.py's phase 20d at 64x48 in both packages.
"""

import numpy as np
import pytest

import chip_smoke
from test_torch_webrtc import _both_on_cpu, case, twin  # noqa: F401
from torch_session import torch_test_limit  # noqa: F401


def _twins(*cases):
    return pytest.mark.parametrize("module,test,vary", cases)


@_twins(
    case("test_aws", "test_sigv4_official_example_vector"),
    case("test_aws", "test_s3url_parse"),
    case("test_aws", "test_awss3src_reads_object"),
    case("test_aws", "test_awss3src_missing_object_errors"),
    case("test_aws", "test_awss3src_bad_credentials_rejected"),
    case("test_aws", "test_awss3putobjectsink_uploads"),
    case("test_aws", "test_awss3sink_multipart_roundtrip"),
    case("test_aws", "test_awss3sink_abort_on_teardown_without_eos"),
    case("test_aws", "test_awss3hlssink_segments_to_s3"),
    case("test_aws", "test_awspolly_synthesizes"),
    case("test_aws", "test_awstranslate_translates"),
    case("test_aws", "test_awstranslate_bad_credentials"),
    case("test_aws", "test_eventstream_roundtrip"),
    case("test_aws", "test_awstranscriber_streaming", clock="state"),
    case("test_aws", "test_awstranscribeparse_batch_json"))
def test_aws_twin(module, test, vary, tmp_path):
    twin(module, test, tmp_path, vary)


@_twins(
    case("test_cloudstt", "test_speechmatics_protocol_end_to_end"),
    case("test_cloudstt", "test_deepgram_protocol_end_to_end"),
    case("test_cloudstt", "test_cloudstt_connect_failure_is_clean"),
    case("test_cloudstt", "test_speechmatics_round5_config_and_masking"),
    case("test_cloudstt", "test_deepgram_round5_knobs", random="req"))
def test_cloudstt_twin(module, test, vary, tmp_path):
    twin(module, test, tmp_path, vary)


@_twins(
    case("test_elevenlabs", "test_synthesizer_tts"),
    case("test_elevenlabs", "test_synthesizer_stitching_ids"),
    case("test_elevenlabs", "test_synthesizer_bad_key"),
    case("test_elevenlabs", "test_voice_cloner"))
def test_elevenlabs_twin(module, test, vary, tmp_path):
    twin(module, test, tmp_path, vary)


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 20d at 64x48 in both packages
# ---------------------------------------------------------------------------

def test_phase20_cloud_edge(tmp_path, monkeypatch):
    """20d at 64x48: the grade through cmafmux into awss3hlssink puts the
    same objects into chip_smoke's S3 stand-in in both packages, every
    request signed; the telephony leg at 16 kHz into deepgramtranscriber
    sends the stand-in the same request line and audio and gets the same
    texts. The port's grade is read by cmafmux alone, once a frame and
    the first frame once more, and by no sink."""
    from test_torch_net import _as_port
    monkeypatch.setattr(chip_smoke, "EDGE_W", 64)
    monkeypatch.setattr(chip_smoke, "EDGE_H", 48)
    cube = tmp_path / "g.cube"
    chip_smoke.write_cube(cube, np.random.default_rng(20), n=9)
    seen = {}
    for name in ("gstpu", "gstpu_torch"):
        with chip_smoke.ArrayCalls() as calls:
            res = chip_smoke.cloud_edge(_as_port(name), "cpu", cube)
        assert res["refused"] == 0 and res["puts"] == 6
        assert sorted(res["objects"]) == [
            "/card/hls/init.mp4", "/card/hls/playlist.m3u8",
            "/card/hls/segment00000.m4s", "/card/hls/segment00001.m4s"]
        assert b"#EXT-X-ENDLIST" in res["objects"]["/card/hls/playlist.m3u8"]
        assert sum(map(len, res["frames"])) == 32000
        assert [t for t, _, _ in res["texts"]] == ["dg1", "dg2"]
        seen[name] = (res["objects"], res["request"], res["frames"],
                      res["texts"]), calls
    assert seen["gstpu"][0] == seen["gstpu_torch"][0]
    calls = seen["gstpu_torch"][1]
    assert chip_smoke.new_reads(calls, ("mux", "s3")) == {
        "mux": chip_smoke.CLOUD_FRAMES + 1}
    assert [calls.of("mux", i * 10 ** 9 // 30)
            for i in range(chip_smoke.CLOUD_FRAMES)] == [2, 1]
