"""raptorqenc / raptorqdec: RTP forward error correction.

Rebuilds the reference net/raptorq elements' model (source blocks of
k RTP packets protected by r repair packets; the receiver recovers
any lost source packets from any k received symbols).  The erasure
code is the systematic GF(256) Reed-Solomon in gstpu/net/fec.py — it
gives the same any-k-of-(k+r) guarantee but is NOT wire-compatible
with RFC 6330 (the reference wraps the raptorq crate; its permanent
code tables aren't reproducible here — see PARITY.md).

Repair packet payload: base_seqnum u16 | k u8 | esi u8 |
symbol_size u16 | symbol.  Symbols are length-prefixed source packets
zero-padded to the block maximum (the RFC 6363 ADUI construction).

The port's copy of gstpu/elements/net/raptorq.py, with one departure:
raptorqdec ignores a repair packet of a block it has already handed on.
gstpu's opens that block anew, where it never completes and holds back
every later block until EOS (a block recovered by its first repair packet
meets its second one next).
"""

from __future__ import annotations

from collections import deque

from gstpu_torch.core.base import BaseTransform
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.element import PadDirection, PadPresence, PadTemplate
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element
from gstpu_torch.net.fec import decode_block, encode_repair
from gstpu_torch.net.rtp.packet import RtpPacket

RTP_CAPS = Caps.new("application/x-rtp")


def _tmpl(name, d):
    return PadTemplate(name, d, PadPresence.ALWAYS, RTP_CAPS.copy())


@register_element("raptorqenc", Rank.NONE)
class RaptorqEnc(BaseTransform):
    PAD_TEMPLATES = [_tmpl("sink", PadDirection.SINK),
                     _tmpl("src", PadDirection.SRC)]

    symbols_per_block = Property(int, default=8, minimum=1,
                                 maximum=255,
                                 mutable=Mutability.READY,
                                 blurb="Source packets per block (k)")
    repair_packets = Property(int, default=2, minimum=1, maximum=64,
                              mutable=Mutability.READY,
                              blurb="Repair packets per block (r)")
    repair_pt = Property(int, default=97, minimum=0, maximum=127,
                         mutable=Mutability.READY)

    def __init__(self, name=None):
        super().__init__(name)
        self._block: list[bytes] = []
        self._base_seq: int | None = None
        self._repair_seq = 0
        self._ssrc = 0x5EC0FEC

    def transform_caps(self, direction, caps, filter):
        out = RTP_CAPS.copy()
        if filter is not None:
            out = filter.intersect(out)
        return out

    def _emit_repair(self) -> list[Buffer]:
        k = len(self._block)
        size = max(len(p) for p in self._block) + 2
        symbols = [len(p).to_bytes(2, "big") + p.ljust(size - 2, b"\0")
                   for p in self._block]
        out = []
        for esi, sym in enumerate(encode_repair(symbols,
                                                self.repair_packets)):
            hdr = (self._base_seq.to_bytes(2, "big")
                   + bytes([k, k + esi]) + size.to_bytes(2, "big"))
            pkt = RtpPacket(payload_type=self.repair_pt,
                            seqnum=self._repair_seq, timestamp=0,
                            ssrc=self._ssrc, payload=hdr + sym)
            self._repair_seq = (self._repair_seq + 1) & 0xFFFF
            out.append(Buffer(pkt.to_bytes()))
        self._block = []
        self._base_seq = None
        return out

    def transform(self, buf: Buffer) -> list[Buffer]:
        data = buf.to_bytes()
        pkt = RtpPacket.parse(data)
        if self._base_seq is None:
            self._base_seq = pkt.seqnum
        self._block.append(data)
        out = [buf]
        if len(self._block) >= self.symbols_per_block:
            out += self._emit_repair()
        return out

    def drain(self) -> list[Buffer]:
        if not self._block:
            return []
        return self._emit_repair()


@register_element("raptorqdec", Rank.NONE)
class RaptorqDec(BaseTransform):
    PAD_TEMPLATES = [_tmpl("sink", PadDirection.SINK),
                     _tmpl("src", PadDirection.SRC)]

    repair_pt = Property(int, default=97, minimum=0, maximum=127,
                         mutable=Mutability.READY)

    def __init__(self, name=None):
        super().__init__(name)
        # base_seq -> {"k", "size", "src": {esi: bytes},
        #              "rep": {esi: bytes}}
        self._blocks: dict[int, dict] = {}
        self._order: list[int] = []
        # source packets whose block (k, base) isn't known yet —
        # adopted as soon as a matching repair packet arrives
        self._orphans: dict[int, bytes] = {}
        # bases of the blocks handed on: their late repair packets
        self._done: deque[int] = deque(maxlen=64)
        self.stats = {"recovered": 0, "unrecovered": 0}

    def transform_caps(self, direction, caps, filter):
        out = RTP_CAPS.copy()
        if filter is not None:
            out = filter.intersect(out)
        return out

    def _block_for(self, base: int, k: int) -> dict:
        blk = self._blocks.get(base)
        if blk is None:
            blk = {"k": k, "size": None, "src": {}, "rep": {}}
            self._blocks[base] = blk
            self._order.append(base)
        return blk

    def _try_finish(self, base: int) -> list[Buffer] | None:
        blk = self._blocks[base]
        k = blk["k"]
        if len(blk["src"]) == k:
            out = [Buffer(blk["src"][i]) for i in range(k)]
        elif len(blk["src"]) + len(blk["rep"]) >= k \
                and blk["size"] is not None:
            size = blk["size"]
            received = {esi: (len(p).to_bytes(2, "big")
                              + p.ljust(size - 2, b"\0"))
                        for esi, p in blk["src"].items()}
            received.update(blk["rep"])
            try:
                symbols = decode_block(k, received)
            except ValueError:
                return None
            self.stats["recovered"] += k - len(blk["src"])
            out = []
            for sym in symbols:
                n = int.from_bytes(sym[:2], "big")
                out.append(Buffer(sym[2:2 + n]))
        else:
            return None
        del self._blocks[base]
        self._order.remove(base)
        self._done.append(base)
        return out

    def transform(self, buf: Buffer) -> list[Buffer] | None:
        data = buf.to_bytes()
        pkt = RtpPacket.parse(data)
        if pkt.payload_type == self.repair_pt:
            pl = pkt.payload
            base = int.from_bytes(pl[:2], "big")
            if base in self._done:
                return None
            k, esi = pl[2], pl[3]
            size = int.from_bytes(pl[4:6], "big")
            blk = self._block_for(base, k)
            blk["size"] = size
            blk["rep"][esi] = pl[6:6 + size]
            for seq in list(self._orphans):
                delta = (seq - base) & 0xFFFF
                if delta < k:
                    blk["src"][delta] = self._orphans.pop(seq)
        else:
            for base, blk in self._blocks.items():
                delta = (pkt.seqnum - base) & 0xFFFF
                if delta < blk["k"]:
                    blk["src"][delta] = data
                    break
            else:
                self._orphans[pkt.seqnum] = data
        out = []
        for base in list(self._order):
            done = self._try_finish(base)
            if done is None:
                break                      # keep ordering
            out.extend(done)
        return out or None

    def drain(self) -> list[Buffer]:
        out = []
        for base in list(self._order):
            done = self._try_finish(base)
            if done is not None:
                out.extend(done)
            else:
                blk = self._blocks[base]
                self.stats["unrecovered"] += 1
                out.extend(Buffer(p) for _, p in
                           sorted(blk["src"].items()))
                del self._blocks[base]
                self._order.remove(base)
        # trailing packets that never saw a repair
        out.extend(Buffer(p) for _, p in sorted(self._orphans.items()))
        self._orphans.clear()
        return out
