"""Sans-IO QUIC v1 (RFC 9000/9001) — the transport the reference's
quinn crate provides.

Scope: a from-the-RFCs implementation of the parts the quinn elements
need — version 1 long/short headers, Initial/Handshake/1-RTT packet
protection (AEAD + header protection), a TLS 1.3 handshake on the
`cryptography` primitives, CRYPTO/ACK/STREAM/DATAGRAM frames, and a
Connection object driven handle_datagram/poll_transmit like the rest
of gstpu's sans-IO stack. Loss recovery/congestion control are not
implemented (the elements run over ICE-verified or loopback paths;
the reference delegates those to quinn-proto).

The port's copy of gstpu/net/quic/__init__.py, as it stands.
"""

# QuicConnection is imported lazily by consumers
# (gstpu_torch.net.quic.connection)
