"""The port's webrtcsink/webrtcsrc shells and the signallers built on
them (Janus VideoRoom, Unreal Engine Pixel Streaming, AWS Kinesis Video
Streams) against gstpu's, on the CPU.

Twins of all of tests/test_webrtcsink_encode.py,
test_webrtcsink_navigation.py, test_webrtcsrc_props.py, test_janusvr.py,
test_ueps.py and test_awskvs.py, each gstpu test run as gstpu's and as the
port's through test_torch_webrtc.twin: both meet its assertions, and what
its body saw is equal but the names listed under a reason of REASONS.
The payloaders' RFC 3550 draws are seeded alike in both packages, so the
RTP the encoder chains send is compared byte for byte. The stand-in
Janus gateway, Pixel Streaming server and AWS endpoints are the gstpu
tests' own, loaded once for each package.
"""

import pytest

from test_torch_webrtc import _both_on_cpu, case, twin  # noqa: F401
from torch_session import torch_test_limit  # noqa: F401


def _twins(*cases):
    return pytest.mark.parametrize("module,test,vary", cases)


@_twins(
    case("test_webrtcsink_encode", "test_discovery_finds_all_canonical_codecs"),
    case("test_webrtcsink_encode", "test_raw_video_encoded_to_av1_rtp"),
    case("test_webrtcsink_encode", "test_bitrate_distribution_and_mitigation"),
    case("test_webrtcsink_encode",
         "test_mitigation_modes_property_gates_the_ladder"),
    case("test_webrtcsink_encode", "test_sub64_input_falls_back_to_rav1e"),
    case("test_webrtcsink_encode",
         "test_encoder_setup_signal_claims_configuration"),
    case("test_webrtcsink_encode", "test_payloader_setup_signal"),
    case("test_webrtcsink_encode", "test_define_encoder_bitrates_override"),
    case("test_webrtcsink_encode", "test_rtx_percentage_scales_allocation"),
    case("test_webrtcsink_encode", "test_configure_mitigation_caps_override"),
    case("test_webrtcsink_encode", "test_consumer_signals_and_sessions"),
    case("test_webrtcsink_encode", "test_gcc_feedback_drives_bitrate"),
    case("test_webrtcsink_encode", "test_cc_disabled"),
    case("test_webrtcsink_encode", "test_av1_chain_prefers_realtime_engine"))
def test_encode_twin(module, test, vary, tmp_path):
    twin(module, test, tmp_path, vary)


@_twins(
    case("test_webrtcsink_navigation",
         "test_input_channel_message_reaches_video_pads"),
    case("test_webrtcsink_navigation", "test_mid_routes_to_one_pad"),
    case("test_webrtcsink_navigation",
         "test_control_channel_envelope_accepted"),
    case("test_webrtcsink_navigation", "test_disabled_by_default"),
    case("test_webrtcsink_navigation",
         "test_non_navigation_messages_pass_through"),
    case("test_webrtcsink_navigation", "test_navigation_rides_live_session",
         clock="deadline"),
    case("test_webrtcsrc_props", "test_connect_to_first_producer_off"),
    case("test_webrtcsrc_props", "test_video_codec_name_filters_answer"),
    case("test_webrtcsrc_props", "test_audio_codec_name_filters_answer"),
    case("test_webrtcsrc_props",
         "test_do_retransmission_off_suppresses_nack_state"),
    case("test_webrtcsrc_props", "test_turn_server_relay_candidate_in_answer",
         port="rport"))
def test_shell_twin(module, test, vary, tmp_path):
    twin(module, test, tmp_path, vary)


@_twins(
    case("test_janusvr", "test_janusvr_sink_publishes"),
    case("test_janusvr", "test_janusvr_src_subscribes"),
    case("test_ueps", "test_ueps_streamer_serves_player"),
    case("test_awskvs", "test_kvs_master_answers_viewer_offer"))
def test_signaller_twin(module, test, vary, tmp_path):
    twin(module, test, tmp_path, vary)
