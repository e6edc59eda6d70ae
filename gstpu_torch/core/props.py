"""Typed, range-checked, mutability-staged element properties.

Rebuilds the GObject property system as used by every reference element
(reference audio/audiofx/src/audioecho/imp.rs:96-133: ParamSpec with
blurb, range, default, mutable_ready/mutable_playing). Properties are
class-level descriptors; values are stored per-instance; changes notify
and are stage-checked against the element state.
"""

from __future__ import annotations

import enum
from typing import Any, Callable


class Mutability(enum.Enum):
    """When may a property be changed? (reference: MUTABLE_READY etc.)"""

    NULL = 0      # only while NULL (construct-ish)
    READY = 1     # while state <= READY
    PAUSED = 2    # while state <= PAUSED
    PLAYING = 3   # anytime, including while PLAYING


class Property:
    """Descriptor declaring a typed element property.

    Usage:
        class AudioEcho(AudioFilter):
            delay = Property(int, default=0, minimum=0, blurb="Delay ns",
                             mutable=Mutability.PLAYING)
    """

    def __init__(self, typ: type, default: Any = None, *, blurb: str = "",
                 minimum: Any = None, maximum: Any = None,
                 mutable: Mutability = Mutability.READY,
                 enum_values: tuple | None = None,
                 readable: bool = True, writable: bool = True):
        self.typ = typ
        self.default = default
        self.blurb = blurb
        self.minimum = minimum
        self.maximum = maximum
        self.mutable = mutable
        self.enum_values = enum_values
        self.readable = readable
        self.writable = writable
        self.name: str = ""  # set by __set_name__

    def __set_name__(self, owner, name):
        self.name = name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return obj._prop_values.get(self.name, self.default)

    def __set__(self, obj, value):
        obj.set_property(self.name, value)

    # -- validation ---------------------------------------------------
    def coerce(self, value: Any) -> Any:
        if self.typ is float and isinstance(value, int):
            value = float(value)
        if self.typ is int and isinstance(value, str):
            value = int(value, 0)
        if self.typ is float and isinstance(value, str):
            value = float(value)
        if self.typ is bool and isinstance(value, str):
            value = value.lower() in ("true", "1", "yes", "on")
        if self.typ is bytes and isinstance(value, str):
            value = value.encode("utf-8")
        if self.typ is not Any and not isinstance(value, self.typ) \
                and value is not None:
            try:
                value = self.typ(value)
            except Exception:
                raise TypeError(
                    f"property {self.name!r}: expected {self.typ.__name__}, "
                    f"got {type(value).__name__}")
        if self.minimum is not None and value is not None \
                and value < self.minimum:
            raise ValueError(f"property {self.name!r}: {value} < min "
                             f"{self.minimum}")
        if self.maximum is not None and value is not None \
                and value > self.maximum:
            raise ValueError(f"property {self.name!r}: {value} > max "
                             f"{self.maximum}")
        if self.enum_values is not None and value not in self.enum_values:
            raise ValueError(f"property {self.name!r}: {value!r} not in "
                             f"{self.enum_values}")
        return value


class HasProperties:
    """Mixin providing set_property/get_property/notify plumbing."""

    def __init__(self):
        self._prop_values: dict[str, Any] = {}
        self._notify_handlers: dict[str, list[Callable]] = {}

    @classmethod
    def list_properties(cls) -> dict[str, Property]:
        out: dict[str, Property] = {}
        for klass in reversed(cls.__mro__):
            for k, v in vars(klass).items():
                if isinstance(v, Property):
                    out[k] = v
        return out

    def _find_property(self, name: str) -> Property:
        # accept both python_name and gst-style-name; a trailing
        # underscore escapes Python keywords (attr `in_` answers for
        # the reference property name "in", e.g. livesync's counters)
        pyname = name.replace("-", "_")
        props = type(self).list_properties()
        if pyname not in props and pyname + "_" in props:
            pyname += "_"
        if pyname not in props:
            raise KeyError(f"{type(self).__name__} has no property {name!r}")
        return props[pyname]

    def set_property(self, name: str, value: Any) -> None:
        prop = self._find_property(name)
        if not prop.writable:
            raise PermissionError(f"property {name!r} is not writable")
        value = prop.coerce(value)
        self._check_mutability(prop)
        self._prop_values[prop.name] = value
        for h in self._notify_handlers.get(prop.name, []):
            h(self, value)

    def get_property(self, name: str) -> Any:
        prop = self._find_property(name)
        return self._prop_values.get(prop.name, prop.default)

    def connect_notify(self, name: str, handler: Callable) -> None:
        prop = self._find_property(name)
        self._notify_handlers.setdefault(prop.name, []).append(handler)

    def _check_mutability(self, prop: Property) -> None:
        """Overridden by Element to enforce stage restrictions."""
