"""The port's element library: every module of gstpu's.

Each module self-registers its elements via @register_element when
imported, under the same factory names as in gstpu, into the port's
own registry; gstpu_torch.init() imports them through register_all().
"""

from __future__ import annotations

import importlib

_MODULES = [
    "gstpu_torch.elements.generic.basic",
    "gstpu_torch.elements.generic.app",
    "gstpu_torch.elements.generic.testsrc",
    "gstpu_torch.elements.generic.file",
    "gstpu_torch.elements.generic.compress",
    "gstpu_torch.elements.generic.plumbing",
    "gstpu_torch.elements.generic.sodium",
    "gstpu_torch.elements.generic.blocking_adapter",
    "gstpu_torch.elements.video.hsv",
    "gstpu_torch.elements.video.colorlut",
    "gstpu_torch.elements.video.av1",
    "gstpu_torch.elements.video.vpx",
    "gstpu_torch.elements.video.videofx",
    "gstpu_torch.elements.video.scale",
    "gstpu_torch.elements.video.convert",
    "gstpu_torch.elements.video.viuer",
    "gstpu_torch.elements.video.compositor",
    "gstpu_torch.elements.video.image",
    "gstpu_torch.elements.video.closedcaption",
    "gstpu_torch.elements.video.scc",
    "gstpu_torch.elements.video.mcc",
    "gstpu_torch.elements.video.cea708",
    "gstpu_torch.elements.video.st2038",
    "gstpu_torch.elements.video.ttjson",
    "gstpu_torch.elements.video.st2038demux",
    "gstpu_torch.elements.video.ccoverlay",
    "gstpu_torch.elements.video.cccombiner",
    "gstpu_torch.elements.video.transcriberbin",
    "gstpu_torch.elements.video.cdg",
    "gstpu_torch.elements.utils_.supervise",
    "gstpu_torch.elements.utils_.fallbacksrc",
    "gstpu_torch.elements.utils_.uriplaylistbin",
    "gstpu_torch.elements.utils_.debugsei",
    "gstpu_torch.elements.text.textelements",
    "gstpu_torch.elements.text.llm",
    "gstpu_torch.elements.analytics.analytics",
    "gstpu_torch.elements.audio.audiofx",
    "gstpu_torch.elements.audio.g711",
    "gstpu_torch.elements.audio.loudnorm",
    "gstpu_torch.elements.audio.rnnoise",
    "gstpu_torch.elements.audio.hrtf",
    "gstpu_torch.elements.audio.convert",
    "gstpu_torch.elements.audio.claxon",
    "gstpu_torch.elements.audio.lewton",
    "gstpu_torch.elements.audio.agingradio",
    "gstpu_torch.elements.audio.audioparsers",
    "gstpu_torch.elements.audio.opus",
    "gstpu_torch.elements.audio.demucs",
    "gstpu_torch.elements.audio.whisper",
    "gstpu_torch.elements.audio.cloudstt",
    "gstpu_torch.elements.audio.elevenlabs",
    "gstpu_torch.elements.mux.fmp4",
    "gstpu_torch.elements.mux.mpegts",
    "gstpu_torch.elements.mux.flvdemux",
    "gstpu_torch.elements.net.rtp_elements",
    "gstpu_torch.elements.net.rtp_video",
    "gstpu_torch.elements.net.udp",
    "gstpu_torch.elements.net.tcp",
    "gstpu_torch.elements.net.rtsp",
    "gstpu_torch.elements.net.hls",
    "gstpu_torch.elements.net.mpegtslive",
    "gstpu_torch.elements.net.raptorq",
    "gstpu_torch.elements.net.webrtcsink",
    "gstpu_torch.elements.net.httpsrc",
    "gstpu_torch.elements.net.quic",
    "gstpu_torch.elements.net.aws",
    "gstpu_torch.elements.net.aws_ai",
    "gstpu_torch.elements.net.janusvr",
    "gstpu_torch.elements.net.aws_transcribe",
    "gstpu_torch.elements.net.ueps",
    "gstpu_torch.elements.net.awskvs",
    "gstpu_torch.elements.net.icecast",
    "gstpu_torch.elements.net.dash",
    "gstpu_torch.elements.net.gccbwe",
    "gstpu_torch.elements.net.onvif",
    # last: _alias reads the registry when it is imported
    "gstpu_torch.elements.generic.aliases",
]

_registered = False


def register_all() -> None:
    global _registered
    if _registered:
        return
    _registered = True
    for mod in _MODULES:
        importlib.import_module(mod)
