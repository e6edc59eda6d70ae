"""Docs-cache generator: emit a machine-readable inventory of every
registered element — name, rank, description, pad templates with
caps, and the full property table.

Mirrors the reference's generated plugin documentation cache
(docs/plugins/gst_plugins_cache.json, kept in sync by
ci/check-documentation-diff.py). `tests/test_docs_cache.py` plays
the CI role: it regenerates the cache and fails if the checked-in
copy is stale.

Usage:
    python -m gstpu_torch.tools.docs_cache [-o docs/plugins/gstpu_torch_plugins_cache.json]

The port's copy of gstpu/tools/docs_cache.py: it documents the port's
factories into a file of the port's own, and initialises the port on
the CPU, since documenting elements needs no device.
"""

from __future__ import annotations

import argparse
import json


def build_cache() -> dict:
    import gstpu_torch
    gstpu_torch.init(device="cpu")
    from gstpu_torch.core.props import Property
    from gstpu_torch.core.registry import (element_factory, element_rank,
                                           list_factories)

    cache: dict = {}
    for name in list_factories():
        cls = element_factory(name)
        doc = (cls.__doc__ or "").strip()
        props = {}
        for klass in reversed(cls.__mro__):
            for attr, val in vars(klass).items():
                if isinstance(val, Property):
                    entry = {
                        "type": getattr(val.typ, "__name__",
                                        str(val.typ)),
                        "default": repr(val.default),
                        "mutable": val.mutable.name.lower(),
                        "readable": val.readable,
                        "writable": val.writable,
                    }
                    if val.blurb:
                        entry["blurb"] = val.blurb
                    if val.minimum is not None:
                        entry["min"] = repr(val.minimum)
                    if val.maximum is not None:
                        entry["max"] = repr(val.maximum)
                    if val.enum_values:
                        entry["enum"] = list(val.enum_values)
                    props[attr] = entry
        pads = [
            {
                "name": t.name_template,
                "direction": t.direction.name.lower(),
                "presence": t.presence.name.lower(),
                "caps": str(t.caps),
            }
            for t in getattr(cls, "PAD_TEMPLATES", [])
        ]
        cache[name] = {
            "rank": element_rank(name).name.lower(),
            "impl": f"{cls.__module__}.{cls.__qualname__}",
            "description": doc.splitlines()[0] if doc else "",
            "pad_templates": pads,
            "properties": props,
        }
    return cache


def render() -> str:
    return json.dumps(build_cache(), indent=1, sort_keys=True) + "\n"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gstpu_torch.tools.docs_cache")
    ap.add_argument("-o", "--output",
                    default="docs/plugins/gstpu_torch_plugins_cache.json")
    args = ap.parse_args(argv)
    text = render()
    import os
    os.makedirs(os.path.dirname(args.output), exist_ok=True)
    with open(args.output, "w") as f:
        f.write(text)
    print(f"wrote {args.output} "
          f"({len(json.loads(text))} elements)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
