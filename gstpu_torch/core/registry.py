"""Element registry: factory names → classes, with ranks.

Rebuilds the GStreamer registry the reference populates via
Element::register in each plugin_init (reference tutorial/src/lib.rs:21-29)
and that auto-plugging consults by rank (e.g. isofmp4mux registers
PRIMARY, mux/isobmff/src/isobmff/mod.rs:137-172).
"""

from __future__ import annotations

import enum
from typing import Type


class Rank(enum.IntEnum):
    NONE = 0
    MARGINAL = 64
    SECONDARY = 128
    PRIMARY = 256


_registry: dict[str, tuple[Type, Rank]] = {}


def register_element(name: str, rank: Rank = Rank.NONE):
    """Class decorator: register an Element subclass under a factory
    name."""

    def deco(cls):
        cls.ELEMENT_NAME = name
        _registry[name] = (cls, rank)
        return cls

    return deco


def element_factory(name: str) -> Type:
    try:
        return _registry[name][0]
    except KeyError:
        raise KeyError(f"no such element factory: {name!r} "
                       f"(did you call gstpu_torch.init()?)")


def element_rank(name: str) -> Rank:
    return _registry[name][1]


def list_factories() -> list[str]:
    return sorted(_registry)


def make(name: str, element_name: str | None = None, **props):
    """Instantiate a registered element (gst_element_factory_make)."""
    if not _registry:
        from gstpu_torch.elements import register_all
        register_all()
    el = element_factory(name)(name=element_name)
    for k, v in props.items():
        el.set_property(k, v)
    return el
