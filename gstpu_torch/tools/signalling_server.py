"""gstpu-signalling-server: standalone WebRTC signalling server
binary (the reference ships this as net/webrtc/signalling's
gst-webrtc-signalling-server; same wire-compatible JSON protocol,
served by gstpu's sans-IO core behind the RFC 6455 WebSocket
frontend).

Usage:
    gstpu-signalling-server --host 0.0.0.0 --port 8443

The port's copy of gstpu/tools/signalling_server.py, as it stands.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="gstpu-signalling-server")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8443)
    args = ap.parse_args(argv)

    from gstpu_torch.net.webrtc.signalling import SignallingServer

    server = SignallingServer(host=args.host, port=args.port)
    server.start()
    print(f"Listening on ws://{args.host}:{server.port}",
          file=sys.stderr)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        print("Shutting down.", file=sys.stderr)
        server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
