"""gstpu_torch launch: build and run a pipeline from its textual
description (gst-launch-1.0 analogue; the description syntax is the
one `gstpu_torch.parse_launch` implements).

Usage:
    python -m gstpu_torch.tools.launch [-q] [-m] [--device DEV] \\
        "audiotestsrc num-buffers=100 ! fakesink"

The port's copy of gstpu/tools/launch.py. It runs on the CUDA device
unless `--device` names another (`--device cpu`): `gstpu_torch.init`
raises where there is no CUDA device and never carries on on the CPU.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gstpu_torch.tools.launch")
    ap.add_argument("pipeline", nargs="+",
                    help="pipeline description (a ! b prop=v ! c)")
    ap.add_argument("-q", "--quiet", action="store_true")
    ap.add_argument("-m", "--messages", action="store_true",
                    help="print bus messages")
    ap.add_argument("--device", default="cuda",
                    help="torch device frames are uploaded to "
                         "(default cuda)")
    args = ap.parse_args(argv)

    import gstpu_torch
    gstpu_torch.init(device=args.device)
    from gstpu_torch import State, parse_launch

    desc = " ".join(args.pipeline)
    try:
        pipeline = parse_launch(desc)
    except Exception as e:
        print(f"ERROR: could not construct pipeline: {e}",
              file=sys.stderr)
        return 1

    if args.messages and pipeline.bus is not None:
        orig_post = pipeline.bus.post

        def tee_post(msg):
            print(f"[bus] {msg}", file=sys.stderr)
            return orig_post(msg)

        pipeline.bus.post = tee_post

    if not args.quiet:
        print("Setting pipeline to PLAYING ...", file=sys.stderr)
    t0 = time.monotonic()
    pipeline.set_state(State.PLAYING)
    try:
        pipeline.run()
    except KeyboardInterrupt:
        if not args.quiet:
            print("Interrupted; stopping.", file=sys.stderr)
    except RuntimeError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        pipeline.set_state(State.NULL)
        return 1
    finally:
        pipeline.set_state(State.NULL)
    if not args.quiet:
        dt = time.monotonic() - t0
        print(f"Execution ended after {dt:.3f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
