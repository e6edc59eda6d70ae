"""The port's element library: the modules ported so far.

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
    "gstpu_torch.elements.video.hsv",
    "gstpu_torch.elements.video.colorlut",
    "gstpu_torch.elements.video.av1",
    "gstpu_torch.elements.audio.audiofx",
    "gstpu_torch.elements.audio.loudnorm",
    "gstpu_torch.elements.audio.rnnoise",
    "gstpu_torch.elements.audio.hrtf",
]

_registered = False


def register_all() -> None:
    global _registered
    if _registered:
        return
    _registered = True
    for mod in _MODULES:
        importlib.import_module(mod)
