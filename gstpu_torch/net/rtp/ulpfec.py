"""RFC 5109 ULPFEC + RFC 2198 RED — sans-IO codecs.

The reference's webrtcsink reserves fec-percentage bitrate headroom
(net/webrtc/src/webrtcsink/imp.rs:1677-1695) and lets webrtcbin's
rtpulpfecenc/rtpulpfecdec produce and consume the actual FEC packets.
gstpu owns its media plane end to end, so the packet-level FEC lives
here: XOR parity per RFC 5109 with the level-0 (equal protection)
profile, plus the RED encapsulation codec (RFC 2198) used by
browser-interop stacks.

Wire mode used by webrtcsink/webrtcsrc: the FEC packets ride a
SEPARATE stream (RFC 5109 §10.1) — own SSRC (media ssrc + 2), own
sequence space, payload type announced in the offer with
``a=rtpmap:<pt> ulpfec/<rate>`` and associated to the protected
stream with ``a=fmtp:<pt> apt=<media pt>`` (the same pairing
convention RFC 4588 uses for rtx; both endpoints here are ours).
RED primary-block encapsulation is implemented and unit-tested as a
codec; the live plane keeps media packets untouched so the
jitterbuffer/RTX/TWCC paths see the unmodified sequence space.

Everything is pure bytes -> bytes (the rtpbin2 sans-IO discipline,
reference net/rtp/src/rtpbin2/session.rs:71-172): encoding takes a
window of media packets and returns FEC packets; recovery takes one
FEC packet plus the received subset and returns the missing media
packet, bit-exact per RFC 5109 §8.2.

The port's copy of gstpu/net/rtp/ulpfec.py, as it stands.
"""

from __future__ import annotations

__all__ = [
    "fec_encode_window", "fec_protected_seqs", "fec_recover",
    "red_encap", "red_parse", "FecDecoder",
]


def _bit_string(pkt: bytes) -> bytes:
    """RFC 5109 §8.1.1: the protected bit string of a media packet —
    the first 8 header bytes, the 16-bit length of everything past
    the fixed 12-byte header, then that tail itself."""
    tail = pkt[12:]
    return pkt[:8] + len(tail).to_bytes(2, "big") + tail


def _xor_into(acc: bytearray, data: bytes) -> None:
    for i, b in enumerate(data):
        acc[i] ^= b


def fec_encode_window(packets: list[bytes], *, fec_pt: int,
                      fec_ssrc: int, seq_start: int,
                      n_fec: int) -> list[bytes]:
    """Protect a window of media RTP packets with ``n_fec`` XOR
    parity packets.  Packets are distributed round-robin across the
    parity packets (fec j protects packets[j::n_fec], the
    distribution rtpulpfecenc uses), so any single loss inside the
    window is recoverable and two losses are when they land in
    different groups.  The seq span per group must fit the 16-bit
    short mask (L=0), which a <=16-packet window guarantees."""
    n_fec = max(1, min(n_fec, len(packets)))
    out = []
    for j in range(n_fec):
        group = packets[j::n_fec]
        out.append(_fec_encode_group(
            group, fec_pt=fec_pt, fec_ssrc=fec_ssrc,
            seq=(seq_start + j) & 0xFFFF))
    return out


def _fec_encode_group(group: list[bytes], *, fec_pt: int,
                      fec_ssrc: int, seq: int) -> bytes:
    seqs = [int.from_bytes(p[2:4], "big") for p in group]
    sn_base = min(seqs)
    mask = 0
    for s in seqs:
        off = (s - sn_base) & 0xFFFF
        if off > 15:
            raise ValueError("FEC group spans more than 16 seqnums")
        mask |= 0x8000 >> off          # bit 0 = MSB = sn_base itself
    prot_len = max(len(p) - 12 for p in group)
    # XOR of the protected bit strings (header part)
    hdr = bytearray(10)
    payload = bytearray(prot_len)
    for p in group:
        bs = _bit_string(p)
        _xor_into(hdr, bs[:10])
        _xor_into(payload, bs[10:])
    # FEC header: E=0, L=0, then the recovered P/X/CC, M/PT fields;
    # the XORed version bits in hdr[0] are discarded per §7.3
    fec_hdr = bytes([
        hdr[0] & 0x3F,                 # E=0 L=0 | P X CC recovery
        hdr[1],                        # M + PT recovery
    ]) + sn_base.to_bytes(2, "big") + hdr[4:8] + hdr[8:10]
    level0 = prot_len.to_bytes(2, "big") + mask.to_bytes(2, "big")
    # the FEC packet's own RTP header: ts mirrors the newest
    # protected packet's media clock (§7.2)
    ts = int.from_bytes(group[-1][4:8], "big")
    rtp = bytes([0x80, fec_pt & 0x7F]) + seq.to_bytes(2, "big") \
        + ts.to_bytes(4, "big") + fec_ssrc.to_bytes(4, "big")
    return rtp + fec_hdr + level0 + bytes(payload)


def fec_protected_seqs(fec_pkt: bytes) -> list[int]:
    """Sequence numbers protected by a (level-0, L=0) FEC packet."""
    if len(fec_pkt) < 12 + 10 + 4:
        raise ValueError("short FEC packet")
    body = fec_pkt[12:]
    if body[0] & 0x40:
        raise ValueError("long (48-bit) masks not produced here")
    sn_base = int.from_bytes(body[2:4], "big")
    mask = int.from_bytes(body[12:14], "big")
    return [(sn_base + i) & 0xFFFF for i in range(16)
            if mask & (0x8000 >> i)]


def fec_recover(fec_pkt: bytes, received: list[bytes],
                missing_seq: int, media_ssrc: int) -> bytes:
    """RFC 5109 §8.2: reconstruct the one missing media packet from
    the FEC packet and the other protected packets."""
    body = fec_pkt[12:]
    prot_len = int.from_bytes(body[10:12], "big")
    hdr = bytearray(body[:2]) + bytearray(body[2:10])
    payload = bytearray(body[14:14 + prot_len])
    for p in received:
        bs = _bit_string(p)
        _xor_into(hdr, bs[:10])
        _xor_into(payload, bs[10:].ljust(len(payload), b"\x00"))
    length = int.from_bytes(hdr[8:10], "big")
    if length > prot_len:
        raise ValueError("FEC length recovery exceeds protection")
    byte0 = 0x80 | (hdr[0] & 0x3F)     # V=2, recovered P/X/CC
    return bytes([byte0, hdr[1]]) \
        + (missing_seq & 0xFFFF).to_bytes(2, "big") \
        + hdr[4:8] + media_ssrc.to_bytes(4, "big") \
        + bytes(payload[:length])


# ---------------------------------------------------------------------------
# RFC 2198 RED


def red_encap(blocks: list[tuple[int, int, bytes]],
              primary: tuple[int, bytes]) -> bytes:
    """Encapsulate redundant ``(pt, ts_offset, data)`` blocks plus
    the primary ``(pt, data)`` into one RED payload (RFC 2198 §3)."""
    out = bytearray()
    for pt, ts_off, data in blocks:
        if not 0 <= ts_off < (1 << 14) or len(data) >= (1 << 10):
            raise ValueError("RED block field overflow")
        word = (1 << 31) | ((pt & 0x7F) << 24) | (ts_off << 10) \
            | len(data)
        out += word.to_bytes(4, "big")
    out.append(primary[0] & 0x7F)      # F=0 terminator header
    for _, _, data in blocks:
        out += data
    out += primary[1]
    return bytes(out)


def red_parse(payload: bytes) -> list[tuple[int, int, bytes]]:
    """Parse a RED payload into ``[(pt, ts_offset, data), ...]``;
    the final entry (ts_offset 0) is the primary block."""
    hdrs: list[tuple[int, int, int]] = []
    i = 0
    while True:
        if i >= len(payload):
            raise ValueError("truncated RED header")
        if not payload[i] & 0x80:      # primary block header (F=0)
            hdrs.append((payload[i] & 0x7F, 0, -1))
            i += 1
            break
        word = int.from_bytes(payload[i:i + 4], "big")
        hdrs.append(((word >> 24) & 0x7F, (word >> 10) & 0x3FFF,
                     word & 0x3FF))
        i += 4
    out = []
    for pt, ts_off, ln in hdrs:
        if ln < 0:                     # primary: the rest
            out.append((pt, 0, payload[i:]))
        else:
            out.append((pt, ts_off, payload[i:i + ln]))
            i += ln
    return out


# ---------------------------------------------------------------------------


class FecDecoder:
    """Receiver-side state: a bounded store of recent media packets
    per SSRC plus pending FEC packets, retried as media trickles in.
    Mirrors rtpulpfecdec's storage/recovery split."""

    def __init__(self, depth: int = 128):
        self.depth = depth
        self._media: dict[int, dict[int, bytes]] = {}  # ssrc -> seq
        self._pending: dict[int, list[bytes]] = {}     # ssrc -> fec

    def add_media(self, pkt: bytes) -> None:
        ssrc = int.from_bytes(pkt[8:12], "big")
        store = self._media.setdefault(ssrc, {})
        store[int.from_bytes(pkt[2:4], "big")] = pkt
        while len(store) > self.depth:
            store.pop(next(iter(store)))

    def seen(self, ssrc: int, seq: int) -> bool:
        return seq in self._media.get(ssrc, ())

    def add_fec(self, fec_pkt: bytes, media_ssrc: int) -> list[bytes]:
        """Ingest one FEC packet; returns any media packets recovered
        now (each is also entered into the store)."""
        self._pending.setdefault(media_ssrc, []).append(fec_pkt)
        return self.retry(media_ssrc)

    def retry(self, media_ssrc: int) -> list[bytes]:
        """Re-attempt recovery with the current store (call after new
        media arrives).  FEC packets whose window is fully received
        or fully recovered are dropped."""
        store = self._media.get(media_ssrc, {})
        recovered: list[bytes] = []
        keep: list[bytes] = []
        for fec in self._pending.get(media_ssrc, []):
            try:
                seqs = fec_protected_seqs(fec)
            except ValueError:
                continue
            missing = [s for s in seqs if s not in store]
            if not missing:
                continue                      # window complete
            if len(missing) > 1:
                keep.append(fec)              # not yet recoverable
                continue
            have = [store[s] for s in seqs if s in store]
            try:
                pkt = fec_recover(fec, have, missing[0], media_ssrc)
            except ValueError:
                continue
            store = self._media.setdefault(media_ssrc, store)
            store[missing[0]] = pkt
            recovered.append(pkt)
        self._pending[media_ssrc] = keep
        if recovered:
            recovered.extend(self.retry(media_ssrc))
        return recovered
