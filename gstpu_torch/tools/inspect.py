"""gstpu_torch inspect: print element details (gst-inspect-1.0
analogue).

Usage:
    python -m gstpu_torch.tools.inspect              # every factory
    python -m gstpu_torch.tools.inspect rsaudioecho  # pads, caps, props

The port's copy of gstpu/tools/inspect.py: it lists and describes the
port's factories. Like the launch tool it initialises the port on the
CUDA device unless `--device` names another.
"""

from __future__ import annotations

import argparse
import sys


def describe(name: str) -> str:
    from gstpu_torch.core.props import Property
    from gstpu_torch.core.registry import element_factory, element_rank

    cls = element_factory(name)
    lines = [f"Factory Details:",
             f"  Name          {name}",
             f"  Class         {cls.__module__}.{cls.__qualname__}",
             f"  Rank          {element_rank(name).name.lower()}"]
    doc = (cls.__doc__ or "").strip().splitlines()
    if doc:
        lines.append(f"  Description   {doc[0]}")
    lines.append("")
    lines.append("Pad Templates:")
    for tmpl in getattr(cls, "PAD_TEMPLATES", []):
        lines.append(f"  {tmpl.name_template}: "
                     f"{tmpl.direction.name} {tmpl.presence.name}")
        lines.append(f"    {tmpl.caps}")
    lines.append("")
    lines.append("Element Properties:")
    props = []
    for klass in cls.__mro__:
        for attr, val in vars(klass).items():
            if isinstance(val, Property) and attr not in \
                    {p[0] for p in props}:
                props.append((attr, val))
    for attr, p in sorted(props):
        rng = ""
        if p.minimum is not None or p.maximum is not None:
            rng = f" range [{p.minimum}, {p.maximum}]"
        en = f" enum {p.enum_values}" if p.enum_values else ""
        lines.append(
            f"  {attr:24s} {getattr(p.typ, '__name__', p.typ)}"
            f" (default {p.default!r}, mutable<={p.mutable.name}"
            f"{rng}{en})")
        if p.blurb:
            lines.append(f"  {'':24s} {p.blurb}")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gstpu_torch.tools.inspect")
    ap.add_argument("element", nargs="?",
                    help="factory name; omit to list all")
    ap.add_argument("--device", default="cuda",
                    help="torch device the port is initialised on "
                         "(default cuda)")
    args = ap.parse_args(argv)

    import gstpu_torch
    gstpu_torch.init(device=args.device)
    from gstpu_torch.core.registry import list_factories

    if args.element is None:
        names = list_factories()
        for n in names:
            print(n)
        print(f"\nTotal count: {len(names)} elements", file=sys.stderr)
        return 0
    try:
        print(describe(args.element))
    except KeyError:
        print(f"No such element or plugin '{args.element}'",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    try:
        raise SystemExit(main())
    except BrokenPipeError:                  # e.g. `... inspect | head`
        raise SystemExit(0)
