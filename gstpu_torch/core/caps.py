"""Caps: typed media format descriptors with negotiation algebra.

Rebuilds the GstCaps capability model every reference element negotiates
against (reference tutorial/src/rgb2gray/imp.rs:192-302 transform_caps;
audio/audiofx/src/audioecho/imp.rs caps templates): a Caps is a
disjunction of Structures; a Structure is a media-type name plus typed
fields whose values are either fixed or constrained (ranges, alternative
lists). Negotiation = intersection; a fixed caps has exactly one
structure with all-fixed fields.

String syntax is gst-launch compatible:
    audio/x-raw, format=F32LE, rate=[1,2147483647], channels={1,2}
"""

from __future__ import annotations

import re
from fractions import Fraction
from typing import Any, Iterable, Iterator


class IntRange:
    """Closed integer range [lo, hi] with optional step."""

    __slots__ = ("lo", "hi", "step")

    def __init__(self, lo: int, hi: int, step: int = 1):
        if lo > hi:
            raise ValueError(f"empty IntRange [{lo},{hi}]")
        self.lo, self.hi, self.step = int(lo), int(hi), int(step)

    def __repr__(self):
        if self.step != 1:
            return f"[{self.lo},{self.hi},{self.step}]"
        return f"[{self.lo},{self.hi}]"

    def __eq__(self, other):
        return (isinstance(other, IntRange) and self.lo == other.lo
                and self.hi == other.hi and self.step == other.step)

    def __hash__(self):
        return hash(("IntRange", self.lo, self.hi, self.step))

    def __contains__(self, v) -> bool:
        return (isinstance(v, int) and self.lo <= v <= self.hi
                and (v - self.lo) % self.step == 0)


class FractionRange:
    """Closed fraction range, e.g. framerates [0/1, 2147483647/1]."""

    __slots__ = ("lo", "hi")

    def __init__(self, lo: Fraction, hi: Fraction):
        lo, hi = Fraction(lo), Fraction(hi)
        if lo > hi:
            raise ValueError("empty FractionRange")
        self.lo, self.hi = lo, hi

    def __repr__(self):
        return f"[{_fmt_value(self.lo)},{_fmt_value(self.hi)}]"

    def __eq__(self, other):
        return (isinstance(other, FractionRange)
                and self.lo == other.lo and self.hi == other.hi)

    def __hash__(self):
        return hash(("FractionRange", self.lo, self.hi))

    def __contains__(self, v) -> bool:
        return isinstance(v, Fraction) and self.lo <= v <= self.hi


class AnyList(tuple):
    """A list of alternative values, written {a, b, c} in caps strings."""

    def __repr__(self):
        return "{" + ",".join(_fmt_value(v) for v in self) + "}"


def _is_fixed_value(v: Any) -> bool:
    return not isinstance(v, (IntRange, FractionRange, AnyList))


def _value_iter(v: Any) -> Iterable[Any]:
    """Iterate the alternatives of a list value (or the single value)."""
    if isinstance(v, AnyList):
        return v
    return (v,)


def _intersect_values(a: Any, b: Any) -> Any | None:
    """Intersection of two field values; None means empty."""
    if isinstance(a, AnyList) or isinstance(b, AnyList):
        out = []
        for av in _value_iter(a):
            for bv in _value_iter(b):
                r = _intersect_values(av, bv)
                if r is not None and r not in out:
                    out.append(r)
        if not out:
            return None
        return out[0] if len(out) == 1 else AnyList(out)
    if isinstance(a, IntRange) and isinstance(b, IntRange):
        # intersection of two arithmetic progressions (CRT): values
        # x ≡ a.lo (mod a.step) and x ≡ b.lo (mod b.step)
        g = _gcd(a.step, b.step)
        if (b.lo - a.lo) % g != 0:
            return None  # phases incompatible (e.g. evens ∩ odds)
        step = a.step * b.step // g
        # find the smallest solution >= max(a.lo, b.lo)
        lo, hi = max(a.lo, b.lo), min(a.hi, b.hi)
        if lo > hi:
            return None
        # solve a.lo + i*a.step ≡ b.lo (mod b.step)
        i = ((b.lo - a.lo) // g * _modinv(a.step // g, b.step // g)) \
            % (b.step // g)
        x0 = a.lo + i * a.step
        if x0 < lo:
            x0 += ((lo - x0 + step - 1) // step) * step
        if x0 > hi:
            return None
        last = x0 + ((hi - x0) // step) * step
        if x0 == last:
            return x0
        return IntRange(x0, last, step)
    if isinstance(a, IntRange):
        return b if b in a else None
    if isinstance(b, IntRange):
        return a if a in b else None
    if isinstance(a, FractionRange) and isinstance(b, FractionRange):
        lo, hi = max(a.lo, b.lo), min(a.hi, b.hi)
        if lo > hi:
            return None
        return lo if lo == hi else FractionRange(lo, hi)
    if isinstance(a, FractionRange):
        return b if b in a else None
    if isinstance(b, FractionRange):
        return a if a in b else None
    if isinstance(a, Caps) and isinstance(b, Caps):
        # nested caps fields (e.g. compress elements' original-caps)
        r = a.intersect(b)
        return None if r.is_empty() else r
    return a if a == b else None


def _value_subset(a: Any, b: Any) -> bool:
    """True if every value admitted by a is admitted by b."""
    if isinstance(a, AnyList):
        return all(_value_subset(av, b) for av in a)
    if isinstance(a, IntRange):
        if isinstance(b, IntRange):
            return (b.lo <= a.lo and a.hi <= b.hi
                    and a.step % b.step == 0 and (a.lo - b.lo) % b.step == 0)
        return False
    if isinstance(a, FractionRange):
        return isinstance(b, FractionRange) and b.lo <= a.lo and a.hi <= b.hi
    return _intersect_values(a, b) == a


def _fixate_value(v: Any, near: Any = None) -> Any:
    if isinstance(v, AnyList):
        if near is not None and near in v:
            return near
        return _fixate_value(v[0], near)
    if isinstance(v, IntRange):
        if isinstance(near, int):
            c = min(max(near, v.lo), v.hi)
            c -= (c - v.lo) % v.step
            return c
        return v.lo
    if isinstance(v, FractionRange):
        if isinstance(near, Fraction) and near in v:
            return near
        return v.lo
    return v


def _gcd(a, b):
    while b:
        a, b = b, a % b
    return a


def _modinv(a: int, m: int) -> int:
    if m == 1:
        return 0
    return pow(a, -1, m)


class Structure:
    """One media-type alternative: name + ordered typed fields."""

    def __init__(self, name: str, **fields: Any):
        self.name = name
        self.fields: dict[str, Any] = dict(fields)

    def __getitem__(self, k):
        return self.fields[k]

    def get(self, k, default=None):
        return self.fields.get(k, default)

    def __setitem__(self, k, v):
        self.fields[k] = v

    def __contains__(self, k):
        return k in self.fields

    def __eq__(self, other):
        return (isinstance(other, Structure) and self.name == other.name
                and self.fields == other.fields)

    def copy(self) -> "Structure":
        return Structure(self.name, **self.fields)

    def is_fixed(self) -> bool:
        return all(_is_fixed_value(v) for v in self.fields.values())

    def intersect(self, other: "Structure") -> "Structure | None":
        if self.name != other.name:
            return None
        out = Structure(self.name)
        keys = list(self.fields) + [k for k in other.fields if k not in self.fields]
        for k in keys:
            if k in self.fields and k in other.fields:
                r = _intersect_values(self.fields[k], other.fields[k])
                if r is None:
                    return None
                out.fields[k] = r
            else:
                out.fields[k] = self.fields.get(k, other.fields.get(k))
        return out

    def is_subset(self, other: "Structure") -> bool:
        """True if self admits no value other doesn't."""
        if self.name != other.name:
            return False
        for k, bv in other.fields.items():
            if k not in self.fields:
                return False
            if not _value_subset(self.fields[k], bv):
                return False
        return True

    def fixate(self, near: "Structure | None" = None) -> "Structure":
        out = Structure(self.name)
        for k, v in self.fields.items():
            nv = near.fields.get(k) if near is not None else None
            out.fields[k] = _fixate_value(v, nv)
        return out

    def __repr__(self):
        if not self.fields:
            return self.name
        f = ", ".join(f"{k}={_fmt_value(v)}" for k, v in self.fields.items())
        return f"{self.name}, {f}"


def _fmt_value(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, Fraction):
        return f"{v.numerator}/{v.denominator}"
    if isinstance(v, str):
        if re.fullmatch(r"[A-Za-z0-9_.:+-]+", v):
            return v
        return '"' + v.replace('"', '\\"') + '"'
    return repr(v)


class Caps:
    """An ordered disjunction of Structures; ANY and EMPTY are special."""

    def __init__(self, structures: Iterable[Structure] = (), any_: bool = False):
        self._any = any_
        self.structures: list[Structure] = [] if any_ else list(structures)

    # -- constructors -------------------------------------------------
    @staticmethod
    def any() -> "Caps":
        return Caps(any_=True)

    @staticmethod
    def empty() -> "Caps":
        return Caps()

    @staticmethod
    def new(name: str, **fields) -> "Caps":
        return Caps([Structure(name, **fields)])

    @staticmethod
    def from_string(s: str) -> "Caps":
        return parse_caps(s)

    # -- predicates ---------------------------------------------------
    def is_any(self) -> bool:
        return self._any

    def is_empty(self) -> bool:
        return not self._any and not self.structures

    def is_fixed(self) -> bool:
        return (not self._any and len(self.structures) == 1
                and self.structures[0].is_fixed())

    def __len__(self):
        return len(self.structures)

    def __iter__(self) -> Iterator[Structure]:
        return iter(self.structures)

    def __getitem__(self, i) -> Structure:
        return self.structures[i]

    def __eq__(self, other):
        return (isinstance(other, Caps) and self._any == other._any
                and self.structures == other.structures)

    def copy(self) -> "Caps":
        return Caps([s.copy() for s in self.structures], any_=self._any)

    # -- algebra ------------------------------------------------------
    def intersect(self, other: "Caps") -> "Caps":
        if self._any:
            return other.copy()
        if other._any:
            return self.copy()
        out = []
        for a in self.structures:
            for b in other.structures:
                r = a.intersect(b)
                if r is not None and r not in out:
                    out.append(r)
        return Caps(out)

    def can_intersect(self, other: "Caps") -> bool:
        return not self.intersect(other).is_empty()

    def is_subset(self, other: "Caps") -> bool:
        if other._any:
            return True
        if self._any:
            return False
        return all(any(a.is_subset(b) for b in other.structures)
                   for a in self.structures)

    def append(self, other: "Caps") -> "Caps":
        if self._any or other._any:
            return Caps.any()
        return Caps(self.structures + other.structures)

    def fixate(self, near: "Caps | None" = None) -> "Caps":
        """Reduce to a single fixed structure (first structure wins)."""
        if self._any:
            raise ValueError("cannot fixate ANY caps")
        if self.is_empty():
            raise ValueError("cannot fixate EMPTY caps")
        n = near.structures[0] if near is not None and len(near) else None
        return Caps([self.structures[0].fixate(n)])

    def filtered(self, name: str) -> "Caps":
        return Caps([s for s in self.structures if s.name == name])

    def map_structures(self, fn) -> "Caps":
        """Apply fn(Structure)->Structure|None to each structure."""
        if self._any:
            return Caps.any()
        out = []
        for s in self.structures:
            r = fn(s.copy())
            if r is not None and r not in out:
                out.append(r)
        return Caps(out)

    def __repr__(self):
        if self._any:
            return "ANY"
        if not self.structures:
            return "EMPTY"
        return "; ".join(repr(s) for s in self.structures)


# ---------------------------------------------------------------------------
# caps string parser (gst-launch syntax)
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""\s*(?:
        (?P<string>"(?:[^"\\]|\\.)*")
      | (?P<fraction>-?\d+/\d+)
      | (?P<float>-?\d+\.\d+)
      | (?P<int>-?\d+(?![\w./]))
      | (?P<word>[A-Za-z0-9_.:+/-]+)
      | (?P<punct>[(){}\[\],;=])
    )""",
    re.VERBOSE,
)


def _tokenize(s: str) -> list[str]:
    toks, pos = [], 0
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if not m:
            if s[pos:].strip() == "":
                break
            raise ValueError(f"caps parse error at {s[pos:pos+20]!r}")
        toks.append(m.group(0).strip())
        pos = m.end()
    return toks


class _P:
    def __init__(self, toks):
        self.toks = toks
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def expect(self, t):
        got = self.next()
        if got != t:
            raise ValueError(f"caps parse: expected {t!r}, got {got!r}")


def _parse_scalar(tok: str) -> Any:
    if tok.startswith('"'):
        return tok[1:-1].replace('\\"', '"')
    if re.fullmatch(r"-?\d+/\d+", tok):
        n, d = tok.split("/")
        return Fraction(int(n), int(d))
    if re.fullmatch(r"-?\d+\.\d+", tok):
        return float(tok)
    if re.fullmatch(r"-?\d+", tok):
        return int(tok)
    if tok in ("true", "TRUE", "True"):
        return True
    if tok in ("false", "FALSE", "False"):
        return False
    # typed value prefix e.g. (int)5 handled by caller; bare word:
    return tok


def _parse_value(p: _P) -> Any:
    t = p.peek()
    if t == "[":
        p.next()
        lo = _parse_scalar(p.next())
        p.expect(",")
        hi = _parse_scalar(p.next())
        step = 1
        if p.peek() == ",":
            p.next()
            step = _parse_scalar(p.next())
        p.expect("]")
        if isinstance(lo, Fraction) or isinstance(hi, Fraction):
            return FractionRange(Fraction(lo), Fraction(hi))
        return IntRange(lo, hi, step)
    if t == "{":
        p.next()
        vals = []
        while p.peek() != "}":
            vals.append(_parse_value(p))
            if p.peek() == ",":
                p.next()
        p.expect("}")
        return AnyList(vals)
    if t == "(":
        # typed literal: (int)5, (string)foo, (fraction)30/1
        p.next()
        typ = p.next()
        p.expect(")")
        v = _parse_value(p)
        if typ in ("int", "i", "uint", "u"):
            return int(v)
        if typ in ("fraction",):
            return v if isinstance(v, Fraction) else Fraction(v)
        if typ in ("boolean", "bool", "b"):
            return v in (True, "true", "TRUE", "True", 1)
        if typ in ("string", "str", "s"):
            return str(v)
        if typ in ("double", "float", "d", "f"):
            return float(v)
        return v
    return _parse_scalar(p.next())


def parse_caps(s: str) -> Caps:
    s = s.strip()
    if s in ("ANY", ""):
        return Caps.any() if s == "ANY" else Caps.empty()
    if s == "EMPTY" or s == "NONE":
        return Caps.empty()
    p = _P(_tokenize(s))
    structures = []
    while p.peek() is not None:
        name = p.next()
        if p.peek() == "=":  # no media type? malformed
            raise ValueError(f"caps parse: structure name expected, got {name}=")
        st = Structure(name)
        while p.peek() == ",":
            p.next()
            key = p.next()
            p.expect("=")
            st.fields[key] = _parse_value(p)
        structures.append(st)
        if p.peek() == ";":
            p.next()
    return Caps(structures)
