"""Reference-exact element names registered as aliases.

The reference registers several elements under names this codebase
implemented with equivalents (imagersdec vs imagedecoder, agingradio
vs rsagingradio...). This module registers those exact names as
aliases so gst-launch lines written for the reference work unchanged.

The port's copy of gstpu/elements/generic/aliases.py's `_alias` and of
three of its rows: those that name the image and aging-radio elements.
gstpu's other rows and its small fill-in elements are still to be
ported (ROADMAP.md, Queue D).
"""

from __future__ import annotations

from gstpu_torch.core.registry import register_element
from gstpu_torch.core.registry import _registry as _REG


def _alias(new: str, existing: str) -> None:
    cls, rank = _REG[existing]
    if new not in _REG:
        # subclass so register_element's ELEMENT_NAME assignment does
        # not rename instances of the original factory
        sub = type(cls.__name__ + "Alias", (cls,), {})
        register_element(new, rank)(sub)


for _new, _old in (
        ("imagersdec", "imagedecoder"),
        ("imagersoverlay", "imageoverlay"),
        # reference factory-name variants of elements we register
        # under their family names
        ("agingradio", "rsagingradio"),
):
    _alias(_new, _old)
