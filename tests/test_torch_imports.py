"""The port stands alone: gstpu_torch and chip_smoke.py import neither
JAX nor gstpu, the port keeps its own element registry, and asking for
a CUDA device where there is none raises instead of falling back."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import gstpu_torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "gstpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "gstpu")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_gstpu_imports(path):
    bad = [n for n in _imported_modules(path) if _forbidden(n)]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("path,names", [
    ("ops/hsv.py", {"hsv_filter_frame"}),
    ("ops/lut.py", {"apply_lut_3d"}),
    ("kernels/__init__.py", {"CudaKernel", "build_all"}),
    ("runtime/device_batch.py", {"DeviceContext", "AuxView", "DeviceRow"}),
])
def test_kernel_wrappers_have_no_fallback_handlers(path, names):
    """No try/except around a kernel's build or launch, or a batched
    fire or copy: a kernel that fails raises to the caller instead of
    handing over to the plain version."""
    tree = ast.parse((ROOT / "gstpu_torch" / path).read_text())
    defs = [n for n in tree.body if getattr(n, "name", None) in names]
    assert len(defs) == len(names)
    for d in defs:
        assert not any(isinstance(n, ast.Try) for n in ast.walk(d)), d.name


def test_failed_build_raises(tmp_path, monkeypatch):
    """A kernel that does not build reaches the caller as an error."""
    from gstpu_torch import kernels
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("#!/bin/sh\necho 'error: refused'\nexit 3\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", f"{nvcc.parent}{os.pathsep}"
                               f"{os.environ.get('PATH', '')}")
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    k = kernels.CudaKernel("hsv_filter_u8", "hsv_filter.cu", {})
    with pytest.raises(RuntimeError, match="nvcc failed") as e:
        kernels.build_all([k])
    assert "error: refused" in str(e.value)
    assert k.launches == 0
    assert not any((tmp_path / "build").iterdir())


def test_import_loads_neither_jax_nor_gstpu():
    """Nor h5py: the sofalizer imports it only to read a SOFA file."""
    code = ("import sys, gstpu_torch\n"
            "gstpu_torch.init(device='cpu')\n"
            "import gstpu_torch.ops.hsv, gstpu_torch.ops.lut\n"
            "import gstpu_torch.ops.loudnorm_dev\n"
            "import gstpu_torch.parallel.chains\n"
            "import gstpu_torch.parallel.checkpoint\n"
            "import gstpu_torch.runtime.device_batch\n"
            "import gstpu_torch.elements.audio.loudnorm\n"
            "import gstpu_torch.ops.ebur128, gstpu_torch.core.adapter\n"
            "import gstpu_torch.core.harness, gstpu_torch.ops.rnnoise\n"
            "import gstpu_torch.ops.fftconv\n"
            "import gstpu_torch.elements.audio.rnnoise\n"
            "import gstpu_torch.elements.audio.hrtf\n"
            "import gstpu_torch.codecs.ffv1, gstpu_torch.native\n"
            "import gstpu_torch.native_ffv1, gstpu_torch.native_codec\n"
            "import gstpu_torch.ops.ffv1_pred, gstpu_torch.ops.av1_intra\n"
            "import gstpu_torch.elements.video.av1\n"
            "import gstpu_torch.elements.video.scale\n"
            "import gstpu_torch.elements.video.convert\n"
            "import gstpu_torch.elements.video.compositor\n"
            "import gstpu_torch.elements.analytics.analytics\n"
            "import gstpu_torch.ops.yolox, gstpu_torch.ops.detection\n"
            "import gstpu_torch.parallel.streams\n"
            "import gstpu_torch.elements.net.onvif\n"
            "import gstpu_torch.elements.generic.file\n"
            "import gstpu_torch.elements.audio.convert\n"
            "import gstpu_torch.codecs.flac, gstpu_torch.codecs.ogg\n"
            "import gstpu_torch.codecs.vorbis, gstpu_torch.codecs.mpegts\n"
            "import gstpu_torch.elements.audio.claxon\n"
            "import gstpu_torch.elements.audio.lewton\n"
            "import gstpu_torch.mux.boxes, gstpu_torch.mux.flv\n"
            "import gstpu_torch.elements.mux.fmp4\n"
            "import gstpu_torch.elements.mux.flvdemux\n"
            "import gstpu_torch.elements.mux.mpegts\n"
            "import gstpu_torch.native, gstpu_torch.codecs.cdg\n"
            "import gstpu_torch.elements.audio.g711\n"
            "import gstpu_torch.elements.audio.agingradio\n"
            "import gstpu_torch.elements.audio.audioparsers\n"
            "import gstpu_torch.elements.audio.opus\n"
            "import gstpu_torch.elements.video.cdg\n"
            "import gstpu_torch.elements.video.videofx\n"
            "import gstpu_torch.elements.video.viuer\n"
            "import gstpu_torch.elements.video.image\n"
            "import gstpu_torch.elements.video.vpx\n"
            "import gstpu_torch.elements.generic.aliases\n"
            "import gstpu_torch.codecs.cea608, gstpu_torch.codecs.cea708\n"
            "import gstpu_torch.codecs.dtvcc, gstpu_torch.codecs.st2038\n"
            "import gstpu_torch.elements.video.closedcaption\n"
            "import gstpu_torch.elements.video.scc\n"
            "import gstpu_torch.elements.video.mcc\n"
            "import gstpu_torch.elements.video.cea708\n"
            "import gstpu_torch.elements.video.st2038\n"
            "import gstpu_torch.elements.video.ttjson\n"
            "import gstpu_torch.elements.video.st2038demux\n"
            "import gstpu_torch.elements.video.ccoverlay\n"
            "import gstpu_torch.elements.video.cccombiner\n"
            "import gstpu_torch.elements.text.textelements\n"
            "import gstpu_torch.codecs.brotli_rfc7932\n"
            "import gstpu_torch.codecs.brotli_ctypes\n"
            "import gstpu_torch.elements.generic.compress\n"
            "import gstpu_torch.elements.generic.plumbing\n"
            "import gstpu_torch.elements.generic.sodium\n"
            "import gstpu_torch.elements.generic.blocking_adapter\n"
            "import gstpu_torch.elements.utils_.supervise\n"
            "import gstpu_torch.elements.utils_.fallbacksrc\n"
            "import gstpu_torch.elements.utils_.uriplaylistbin\n"
            "import gstpu_torch.elements.utils_.debugsei\n"
            "import gstpu_torch.elements.video.transcriberbin\n"
            "import gstpu_torch.net.rtp.packet\n"
            "import gstpu_torch.native_net, gstpu_torch.net.fec\n"
            "import gstpu_torch.net.rtp.basepay\n"
            "import gstpu_torch.net.rtp.session\n"
            "import gstpu_torch.net.rtp.jitterbuffer\n"
            "import gstpu_torch.net.rtp.mparobust, gstpu_torch.net.rtp.gcc\n"
            "import gstpu_torch.codecs.rtpjpeg\n"
            "import gstpu_torch.elements.net.udp\n"
            "import gstpu_torch.elements.net.rtp_elements\n"
            "import gstpu_torch.elements.net.rtp_video\n"
            "import gstpu_torch.elements.net.raptorq\n"
            "import gstpu_torch.elements.net.gccbwe\n"
            "import gstpu_torch.elements.net.tcp\n"
            "import gstpu_torch.elements.net.rtsp\n"
            "import gstpu_torch.elements.net.mpegtslive\n"
            "import gstpu_torch.net.replay, gstpu_torch.net.webrtc.dtls\n"
            "import gstpu_torch.net.quic.packet\n"
            "import gstpu_torch.net.quic.recovery\n"
            "import gstpu_torch.net.quic.tls13\n"
            "import gstpu_torch.net.quic.connection\n"
            "import gstpu_torch.net.quic.webtransport\n"
            "import gstpu_torch.net.roq\n"
            "import gstpu_torch.elements.net.quic\n"
            "import gstpu_torch.elements.net.httpsrc\n"
            "import gstpu_torch.elements.net.hls\n"
            "import gstpu_torch.elements.net.dash\n"
            "import gstpu_torch.elements.net.icecast\n"
            "import gstpu_torch.utils.validate\n"
            "import gstpu_torch.tools.launch, gstpu_torch.tools.inspect\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'gstpu', 'h5py')]\n"
            "print(len(sys.modules), bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_register_all_imports_no_cryptography():
    """The QUIC, DTLS and packet-protection modules need `cryptography`,
    which a machine may lack: registering every element imports none of
    it (the quinn elements import their connection when they start)."""
    code = ("import sys, gstpu_torch\n"
            "gstpu_torch.init(device='cpu')\n"
            "from gstpu_torch.core.registry import list_factories\n"
            "assert 'quinnquicsink' in list_factories()\n"
            "bad = [m for m in sys.modules if m.split('.')[0] == "
            "'cryptography' or m.startswith('gstpu_torch.net.quic.') "
            "or m.startswith('gstpu_torch.net.webrtc')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_init_cuda_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        gstpu_torch.init(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        gstpu_torch.init()


def test_port_has_its_own_registry():
    import gstpu
    from gstpu.core.registry import element_factory as jax_factory
    from gstpu.core.registry import element_rank as jax_rank
    from gstpu_torch.core.registry import (element_factory, element_rank,
                                           list_factories)
    gstpu.init()
    gstpu_torch.init(device="cpu")
    names = ("hsvfilter", "hsvdetector", "colorlut", "appsrc",
             "videotestsrc", "rsaudioecho", "audiornnoise", "hrtfrender",
             "sofalizer", "ffv1enc", "ffv1dec", "rav1enc", "dav1ddec",
             "videoscale", "videoconvert", "compositor", "skiacompositor",
             "yoloxinference", "yoloxtensordec", "burn-yoloxinference",
             "analyticscombiner", "analyticssplitter",
             "handdetectiontensordec", "onvifmeta2relationmeta",
             "relationmeta2onvifmeta",
             # the file-to-file host edge
             "filesrc", "filesink", "audioconvert", "audioresample",
             "audiomixer", "claxondec", "oggdemux", "lewtondec",
             "isomp4mux", "isofmp4mux", "cmafmux", "dashmp4mux",
             "onviffmp4mux", "onvifmp4mux", "rsflvdemux", "mpegtsmux",
             "hlssink3",
             # the host codecs and images, and three aliases
             "alawenc", "alawdec", "mulawenc", "mulawdec", "rsagingradio",
             "ac4parse", "s302mparse", "cdgparse", "cdgdec",
             "roundedcorners", "colordetect", "videocompare", "viuersink",
             "rspngenc", "imagedecoder", "gifenc", "gifdec", "rswebpdec",
             "imageoverlay", "vp8enc", "vp9enc", "vp8dec", "vp9dec",
             "opusenc", "opusdec", "imagersdec", "imagersoverlay",
             "agingradio",
             # closed captions, SMPTE ST 2038 and the text elements
             "tttocea608", "cea608tott", "ccdetect", "cea608mux",
             "sccparse", "sccenc", "mccparse", "mccenc", "cea608tocea708",
             "cdpserviceinject", "cea708mux", "tttocea708",
             "cctost2038anc", "st2038anctocc", "st2038combiner",
             "st2038extractor", "cea608tojson", "jsontovtt", "tttojson",
             "st2038ancdemux", "st2038ancmux", "cea608overlay",
             "cea708overlay", "cccombiner", "ccextractor", "regex",
             "textwrap", "jsongstenc", "jsongstparse", "textaccumulate",
             "textahead",
             # plumbing, compression, sodium, the supervisors, fallbacksrc,
             # transcriberbin and the alias rows of Queue D item 3
             "flatecompress", "flatedecompress", "brotlicompress",
             "brotlidecompress", "streamgrouper", "originalbuffersave",
             "originalbufferrestore", "gopbuffer", "intersink", "intersrc",
             "sodiumencrypter", "sodiumdecrypter", "ts-blocking-adapter",
             "fallbackswitch", "livesync", "togglerecord", "fallbacksrc",
             "uriplaylistbin", "debugseimetainserter", "transcriberbin",
             "translationbin", "rsidentity", "rsfilesrc", "rsfilesink",
             "deflatecompress", "deflatedecompress", "zlibcompress",
             "zlibdecompress", "ts-queue", "ts-appsrc", "ts-audiotestsrc",
             "ts-intersink", "ts-intersrc", "ts-proxysink", "ts-proxysrc",
             "rssinesrc", "rsrgb2gray", "rsprogressbin", "ts-clocksync",
             "ts-input-selector", "ts-rtpdtmfsrc")
    # the RTP stack, UDP/TCP/RTSP, ONVIF metadata, FEC and GCC of Queue D
    # item 4, and their alias rows
    item4 = ("rtpL8pay2", "rtpL8depay2", "rtpL16pay2", "rtpL16depay2",
             "rtpL24pay2", "rtpL24depay2", "rtppcmapay2", "rtppcmadepay2",
             "rtppcmupay2", "rtppcmudepay2", "rtpopuspay2", "rtpopusdepay2",
             "rtpamrpay2", "rtpamrdepay2", "rtpamrwbpay2", "rtpamrwbdepay2",
             "rtpac3pay2", "rtpac3depay2", "rtpmpapay2", "rtpmpadepay2",
             "rtpmparobustdepay2", "rtpmp4gpay2", "rtpmp4gdepay2",
             "rtpmp4apay2", "rtpmp4adepay2", "rtpmpvpay2", "rtpmpvdepay2",
             "rtpmp2tpay2", "rtpmp2tdepay2", "rtpjpegpay2", "rtpjpegdepay2",
             "rtpklvpay2", "rtpklvdepay2", "rtpsmpte291pay2",
             "rtpsmpte291depay2", "rtpsend", "rtprecv", "rtpvp8pay2",
             "rtpvp8depay2", "rtpvp9pay2", "rtpvp9depay2", "rtpav1pay2",
             "rtpav1depay2", "rtpvrawpay2", "rtpvrawdepay2",
             "onvifmetadatapay", "onvifmetadatadepay", "onvifmetadataparse",
             "onvifmetadatacombiner", "onvifmetadataoverlay",
             "onvifmetadataextractor", "udpsrc", "udpsink", "tcpclientsrc",
             "tcpserversink", "rtspsrc2", "raptorqenc", "raptorqdec",
             "rtpgccbwe", "mpegtslivesrc", "udpsrc2", "rtponvifmetadatapay",
             "rtponvifmetadatadepay", "ts-udpsrc", "ts-udpsink",
             "ts-tcpclientsrc", "rtpav1pay", "rtpav1depay", "rtpsmpte291pay",
             "rtpsmpte291depay")
    assert len(set(item4)) == 70
    names += item4
    # the HLS/DASH sinks, the HTTP source, Icecast and QUIC/WebTransport/
    # RoQ of Queue D item 5
    item5 = ("hlscmafsink", "hlsmultivariantsink", "hlswebvttsink",
             "dashsink2", "reqwesthttpsrc", "icecastsink", "quinnquicsink",
             "quinnquicsrc", "quinnquicmux", "quinnquicdemux",
             "quinnwtserversink", "quinnwtsink", "quinnwtclientsrc",
             "quinnwtsrc", "quinnroqmux", "quinnroqdemux")
    assert len(set(item5)) == 16
    names += item5
    for name in names:
        port, ref = element_factory(name), jax_factory(name)
        assert port is not ref
        assert port.__module__.startswith("gstpu_torch.")
        assert ref.__module__.startswith("gstpu.")
        assert element_rank(name) == jax_rank(name), name
    assert set(names) <= set(list_factories())
    assert len(list_factories()) == 237
    # gstpu's 268 less the WebRTC elements of Queue D item 6 and the cloud
    # and model elements of item 7
    from gstpu.core.registry import list_factories as jax_factories
    missing = {
        # item 6
        "webrtcsink", "webrtcsrc", "webrtcsend", "webrtcrecv",
        "whipsink", "whipclientsink", "whipserversrc", "whepsrc",
        "whepclientsrc", "whepserversink", "janusvrwebrtcsink",
        "janusvrwebrtcsrc", "uepswebrtcsink", "awskvswebrtcsink",
        # item 7
        "awss3src", "awss3sink", "awss3putobjectsink", "awss3hlssink",
        "awstranscriber", "awstranscriber2", "awstranscribeparse",
        "awstranslate", "awspolly", "deepgramtranscriber",
        "speechmaticstranscriber", "whispertranscriber",
        "elevenlabssynthesizer", "elevenlabsvoicecloner", "demucs",
        "llamatexttransform", "llamacpp-texttransform"}
    assert len(missing) == 31
    assert set(jax_factories()) - set(list_factories()) == missing
    assert set(list_factories()) <= set(jax_factories())
    # the ONVIF payloaders are ported beside the converters: the port's
    # classes, from the module the converters import their names from
    from gstpu_torch.elements.net import onvif
    assert element_factory("onvifmetadatapay") is onvif.OnvifMetadataPay
    assert element_factory("onvifmetadatadepay") is onvif.OnvifMetadataDepay


def test_a420_templates_match_gstpu():
    """`videofx` adds A420 to each package's video formats when it is
    imported, so a template made from the format list before that import
    lacks it. After init(), in a fresh process, every factory the port
    registers lists A420 on the same pads as gstpu's, and both size an
    A420 frame alike."""
    code = ("import gstpu, gstpu_torch\n"
            "from gstpu.core import registry as jr, video as jv\n"
            "from gstpu_torch.core import registry as pr, video as pv\n"
            "gstpu.init()\n"
            "gstpu_torch.init(device='cpu')\n"
            "def a420(reg, name):\n"
            "    return [(t.name_template, 'A420' in repr(t.caps))\n"
            "            for t in reg.element_factory(name).PAD_TEMPLATES]\n"
            "names = pr.list_factories()\n"
            "bad = [n for n in names if a420(pr, n) != a420(jr, n)]\n"
            "has = [n for n in names if any(x for _, x in a420(pr, n))]\n"
            "sizes = {(jv.VideoInfo('A420', w, h).size,\n"
            "          pv.VideoInfo('A420', w, h).size)\n"
            "         for w, h in ((32, 32), (33, 17), (1920, 1080))}\n"
            "print(bad, has, sizes)\n"
            "assert not bad and 'roundedcorners' in has\n"
            "assert all(a == b for a, b in sizes), sizes\n"
            "assert ('A420' in pv.ALL_VIDEO_FORMATS) == \\\n"
            "    ('A420' in jv.ALL_VIDEO_FORMATS)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_rsaudioecho_with_context_raises():
    """A context-block that disagrees with the context the element
    joins stops the element from starting: the members of one context
    share one block."""
    from gstpu_torch.runtime.device_batch import DeviceContext
    gstpu_torch.init(device="cpu")
    DeviceContext.release("ctx")
    DeviceContext.acquire("ctx", 512)
    el = gstpu_torch.make("rsaudioecho", context="ctx", context_block=256)
    with pytest.raises(ValueError, match="context-block"):
        el.start()
    DeviceContext.release("ctx")


def test_rsaudioecho_has_no_context_block():
    """Without `context-block` the element names no block (the context
    keeps its own, 19200 by default); a launch string's context-block is
    read and becomes the block of the context it creates."""
    from gstpu_torch.runtime.device_batch import DeviceContext
    gstpu_torch.init(device="cpu")
    assert gstpu_torch.make("rsaudioecho").context_block is None
    DeviceContext.release("cb")
    p = gstpu_torch.parse_launch(
        "audiotestsrc num-buffers=1 ! rsaudioecho name=e context=cb "
        "context-block=256 ! fakesink")
    assert p.get_by_name("e").context_block == 256
    p.set_state(gstpu_torch.State.READY)
    assert DeviceContext.acquire("cb").block == 256
    p.set_state(gstpu_torch.State.NULL)
    DeviceContext.release("cb")
