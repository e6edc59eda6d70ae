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
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'gstpu', 'h5py')]\n"
            "print(len(sys.modules), bad)\n"
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
    from gstpu_torch.core.registry import element_factory, list_factories
    gstpu.init()
    gstpu_torch.init(device="cpu")
    names = ("hsvfilter", "hsvdetector", "colorlut", "appsrc",
             "videotestsrc", "rsaudioecho", "audiornnoise", "hrtfrender",
             "sofalizer", "ffv1enc", "ffv1dec", "rav1enc", "dav1ddec",
             "videoscale", "videoconvert", "compositor", "skiacompositor",
             "yoloxinference", "yoloxtensordec", "burn-yoloxinference",
             "analyticscombiner", "analyticssplitter",
             "handdetectiontensordec", "onvifmeta2relationmeta",
             "relationmeta2onvifmeta")
    for name in names:
        port, ref = element_factory(name), jax_factory(name)
        assert port is not ref
        assert port.__module__.startswith("gstpu_torch.")
        assert ref.__module__.startswith("gstpu.")
    assert set(names) <= set(list_factories())
    # the ONVIF converters are ported; gstpu's RTP payloaders are not
    assert not {"onvifmetadatapay", "onvifmetadatadepay"} \
        & set(list_factories())


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
