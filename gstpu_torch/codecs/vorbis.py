"""Vorbis I decoder (headers, codebooks, floor1, residue 0/1/2,
coupling, IMDCT, windowing).

Rebuilds the decoding the reference gets from the lewton crate
(audio/lewton lewtondec), implemented from the Vorbis I
specification.  numpy does the IMDCT (precomputed cosine matrices);
the bitstream side is host Python.
The floor1 inverse-dB table is the exact 256-constant table from
the Vorbis I specification (section 7.2.1), so floor curves match
libvorbis/lewton bit-for-bit.

The port's copy of gstpu/codecs/vorbis.py: numpy on the host, as there.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np


def ilog(x: int) -> int:
    """Position of the highest set bit (spec 9.2.1): ilog(0)=0."""
    r = 0
    while x > 0:
        r += 1
        x >>= 1
    return r


def float32_unpack(x: int) -> float:
    mantissa = x & 0x1FFFFF
    sign = -1.0 if x & 0x80000000 else 1.0
    exp = (x & 0x7FE00000) >> 21
    return sign * mantissa * 2.0 ** (exp - 788)


class BitReader:
    """LSB-first bit reader (Vorbis packs into bytes LSb first)."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0                       # bit position

    def read(self, n: int) -> int:
        if self.pos + n > len(self.data) * 8:
            raise EOFError("end of packet")
        v = 0
        got = 0
        pos = self.pos
        while got < n:
            byte = self.data[pos >> 3]
            avail = 8 - (pos & 7)
            take = min(avail, n - got)
            bits = (byte >> (pos & 7)) & ((1 << take) - 1)
            v |= bits << got
            got += take
            pos += take
        self.pos = pos
        return v

    def read_flag(self) -> bool:
        return bool(self.read(1))


# -- codebooks -----------------------------------------------------------

class Codebook:
    def __init__(self, br: BitReader):
        if br.read(24) != 0x564342:
            raise ValueError("codebook sync lost")
        self.dims = br.read(16)
        entries = br.read(24)
        lengths = [0] * entries            # 0 = unused
        if not br.read_flag():             # unordered
            sparse = br.read_flag()
            for i in range(entries):
                if sparse:
                    if br.read_flag():
                        lengths[i] = br.read(5) + 1
                else:
                    lengths[i] = br.read(5) + 1
        else:                              # ordered
            cur_len = br.read(5) + 1
            cur = 0
            while cur < entries:
                num = br.read(ilog(entries - cur))
                for i in range(cur, cur + num):
                    lengths[i] = cur_len
                cur += num
                cur_len += 1
        self._build_tree(lengths)
        # VQ lookup
        self.lookup_type = br.read(4)
        self.vq = None
        if self.lookup_type in (1, 2):
            minimum = float32_unpack(br.read(32))
            delta = float32_unpack(br.read(32))
            value_bits = br.read(4) + 1
            sequence_p = br.read_flag()
            if self.lookup_type == 1:
                lv = 0
                while (lv + 1) ** self.dims <= entries:
                    lv += 1
                lookup_values = lv
            else:
                lookup_values = entries * self.dims
            mults = [br.read(value_bits) for _ in range(lookup_values)]
            vq = np.zeros((entries, self.dims), np.float32)
            for e in range(entries):
                last = 0.0
                idx_div = 1
                for j in range(self.dims):
                    if self.lookup_type == 1:
                        off = (e // idx_div) % lookup_values
                        idx_div *= lookup_values
                    else:
                        off = e * self.dims + j
                    v = mults[off] * delta + minimum + last
                    if sequence_p:
                        last = v
                    vq[e, j] = v
            self.vq = vq
        elif self.lookup_type != 0:
            raise ValueError(f"bad lookup type {self.lookup_type}")

    def _build_tree(self, lengths: list[int]) -> None:
        """First-fit canonical Vorbis codeword assignment (spec 3.2.1);
        decode tree as flat arrays (node -> [bit0, bit1] targets,
        negative = ~entry, 0 = unassigned)."""
        self.tree = [[0, 0]]
        available = [0] * 33
        first = True
        for entry, ln in enumerate(lengths):
            if ln == 0:
                continue
            if first:
                code32 = 0
                for i in range(1, ln + 1):
                    available[i] = 1 << (32 - i)
                first = False
            else:
                z = ln
                while z > 0 and not available[z]:
                    z -= 1
                if z == 0:
                    raise ValueError("codebook overspecified")
                code32 = available[z]
                available[z] = 0
                for i in range(z + 1, ln + 1):
                    available[i] = code32 + (1 << (32 - i))
            code = code32 >> (32 - ln)
            node = 0
            for b in range(ln - 1, -1, -1):
                bit = (code >> b) & 1
                if b == 0:
                    self.tree[node][bit] = ~entry
                else:
                    nxt = self.tree[node][bit]
                    if nxt <= 0:
                        self.tree.append([0, 0])
                        nxt = len(self.tree) - 1
                        self.tree[node][bit] = nxt
                    node = nxt

    def decode(self, br: BitReader) -> int:
        node = 0
        while True:
            t = self.tree[node][br.read(1)]
            if t <= 0:
                if t == 0:
                    raise ValueError("invalid codeword")
                return ~t
            node = t

    def decode_vq(self, br: BitReader) -> np.ndarray:
        return self.vq[self.decode(br)]


# -- floors ---------------------------------------------------------------

_RANGES = {1: 256, 2: 128, 3: 86, 4: 64}

# floor1 inverse dB table: the 256 float constants from the Vorbis I
# specification (FLOOR1_fromdB_LOOKUP, spec section 7.2.1 "floor1
# inverse dB table"); stored as exact IEEE-754 bit patterns so decode
# is bit-identical to libvorbis/lewton.
_INV_DB = np.frombuffer(bytes.fromhex(
    "3eb4e4330991f3338bb201343c200a34231a133460a91c34a7d726344baf3134"
    "503b3d347087493423a05634b8926434556d7334889f8134fc0b8a3493049334"
    "69929c3432bfa6343f95b134931fbd34e469c934ad80d6343671e434a649f334"
    "888c0135c0f7093506ef1235767b1c35c0a62635377b3135da033d355e4c4935"
    "3b615635b94f6435fc2573358a79813586e389357cd9923585649c35528ea635"
    "3361b13525e8bc35dc2ec935ce41d635412ee4355702f3358f6601364fcf0936"
    "f5c31236984d1c36e87526363247313674cc3c365e11493665225636ce0c6436"
    "b8de7236975381361cbb893672ae9236af369c36815da636352db136c7b0bc36"
    "e4f3c8360103d63660ebe3361ebbf236a2400137eba60937f1981237c91f1c37"
    "1e4526373d1331371e953c376fd64837a2e35537f7c9633789977237af2d8137"
    "be92893774839237e6089c37be2ca63747f9b0377979bc37feb8c83747c4d537"
    "92a8e337f873f237c01a0138937e0938f96d123806f21b386214263856df3038"
    "d85d3c38929b4838f2a45538338763386e507238d30781386b6a893882589238"
    "2adb9b3809fca53868c5b0383b42bc38297ec838a085d538d965e338e82cf238"
    "e9f40039465609390e43123951c41b39b5e325397fab3039a2263c39c5604839"
    "53665539834463396809723901e28039244289399d2d92397bad9b3963cba539"
    "9991b0390d0bbc396643c8390b47d5393223e339ede5f1391dcf003a052e093a"
    "3018123aa9961b3a15b3253ab777303a7cef3b3a0a26483ac727553ae601633a"
    "78c2713a3bbc803ae919893ac602923adb7f9b3acb9aa53ad85db03aefd3bb3a"
    "b308c83a8808d53a9fe0e23a079ff13a5ca9003bd005093b5eed113b0f691b3b"
    "8482253bfd43303b67b83b3b61eb473b4de9543b5dbf623b9c7b713b7f96803b"
    "baf1883bf9d7913b47529b3b416aa53b272ab03be29cbb3b12cec73b17cad43b"
    "209ee23b3558f13ba683003ca7dd083c98c2113c823b1b3c0152253c5410303c"
    "61813b3cc8b0473ce5aa543ce87c623cd434713ccf70803c96c9883c3aad913c"
    "c0249b3cc539a53c85f6af3ce565bb3c8293c73cb98bd43cb45be23c7911f13c"
    "fb5d003d89b5083ddf97113d020e1b3d8d21253db9dc2f3d6d4a3b3d4076473d"
    "916c543d853a623d22ee703d2a4b803d7fa1883d8882913d48f79a3d5809a53d"
    "f2c2af3df82ebb3d0359c73d6d4dd43d5c19e23dd1caf03d5b38003e778d083e"
    "336d113e90e01a3e27f1243e2ea92f3e87133b3eca3b473e4d2e543e37f8613e"
    "84a7703e8f25803e7379883ee257913edcc99a3ef9d8a43e6d8faf3e1bf8ba3e"
    "951ec73e330fd43e17d7e13e3d84f03ec612003f7265083f9342113f2bb31a3f"
    "cec0243fb1752f3fb2dc3a3f6501473f1df0533ffbb5613ffb60703f0000803f"), "<f4")


@dataclass
class Floor1:
    partition_classes: list
    class_dims: list
    class_subs: list
    class_masterbooks: list
    subclass_books: list
    multiplier: int
    xs: list

    @staticmethod
    def parse(br: BitReader):
        partitions = br.read(5)
        pclasses = [br.read(4) for _ in range(partitions)]
        maxc = max(pclasses) + 1 if pclasses else 0
        dims, subs, masters, books = [], [], [], []
        for _ in range(maxc):
            dims.append(br.read(3) + 1)
            s = br.read(2)
            subs.append(s)
            masters.append(br.read(8) if s else -1)
            books.append([br.read(8) - 1 for _ in range(1 << s)])
        multiplier = br.read(2) + 1
        rangebits = br.read(4)
        xs = [0, 1 << rangebits]
        for p in pclasses:
            for _ in range(dims[p]):
                xs.append(br.read(rangebits))
        return Floor1(pclasses, dims, subs, masters, books,
                      multiplier, xs)

    def decode(self, br: BitReader, codebooks) -> list | None:
        if not br.read_flag():
            return None
        rng = _RANGES[self.multiplier]
        ys = [br.read(ilog(rng - 1)), br.read(ilog(rng - 1))]
        for p in self.partition_classes:
            cbits = self.class_subs[p]
            csub = (1 << cbits) - 1
            cval = 0
            if cbits:
                cval = codebooks[self.class_masterbooks[p]].decode(br)
            for _ in range(self.class_dims[p]):
                book = self.subclass_books[p][cval & csub]
                cval >>= cbits
                ys.append(codebooks[book].decode(br)
                          if book >= 0 else 0)
        return ys

    def curve(self, ys: list, n2: int) -> np.ndarray:
        """Synthesize the floor curve over n2 spectral bins."""
        rng = _RANGES[self.multiplier]
        xs = self.xs
        npts = len(xs)
        final = [0] * npts
        step2 = [False] * npts
        final[0], final[1] = ys[0], ys[1]
        step2[0] = step2[1] = True
        for i in range(2, npts):
            lo = max((j for j in range(i) if xs[j] < xs[i]),
                     key=lambda j: xs[j], default=0)
            hi = min((j for j in range(i) if xs[j] > xs[i]),
                     key=lambda j: xs[j], default=1)
            pred = _render_point(xs[lo], final[lo], xs[hi], final[hi],
                                 xs[i])
            val = ys[i]
            highroom = rng - pred
            lowroom = pred
            room = 2 * min(highroom, lowroom)
            if val:
                step2[lo] = step2[hi] = step2[i] = True
                if val >= room:
                    if highroom > lowroom:
                        final[i] = val - lowroom + pred
                    else:
                        final[i] = pred - val + highroom - 1
                elif val % 2:
                    final[i] = pred - (val + 1) // 2
                else:
                    final[i] = pred + val // 2
            else:
                step2[i] = False
                final[i] = pred
        # render lines between step2 points, sorted by x
        order = sorted(range(npts), key=lambda j: xs[j])
        floor = np.zeros(n2, np.float32)
        hx = hy = 0
        lx, ly = 0, final[order[0]] * self.multiplier
        for j in order[1:]:
            if not step2[j]:
                continue
            hx = xs[j]
            hy = min(final[j], rng - 1) * self.multiplier
            _render_line(lx, ly, hx, hy, floor)
            lx, ly = hx, hy
        if hx < n2:
            _render_line(hx, hy, n2, hy, floor)
        return floor


def _render_point(x0, y0, x1, y1, x) -> int:
    dy = y1 - y0
    adx = x1 - x0
    err = abs(dy) * (x - x0)
    off = err // adx if adx else 0
    return y0 - off if dy < 0 else y0 + off


def _render_line(x0, y0, x1, y1, out: np.ndarray) -> None:
    dy = y1 - y0
    adx = x1 - x0
    if adx <= 0:
        return
    base = dy // adx if dy >= 0 else -((-dy) // adx)
    ady = abs(dy) - abs(base) * adx
    sy = base + (1 if dy >= 0 else -1)
    x, y, err = x0, y0, 0
    n = len(out)
    if x0 < n:
        out[x0] = _INV_DB[min(max(y0, 0), 255)]
    for x in range(x0 + 1, min(x1, n)):
        err += ady
        if err >= adx:
            err -= adx
            y += sy
        else:
            y += base
        out[x] = _INV_DB[min(max(y, 0), 255)]


# -- residues ---------------------------------------------------------------

@dataclass
class Residue:
    rtype: int
    begin: int
    end: int
    part_size: int
    n_class: int
    classbook: int
    books: list                             # [class][pass] -> book|-1

    @staticmethod
    def parse(br: BitReader, rtype: int):
        begin, end = br.read(24), br.read(24)
        part_size = br.read(24) + 1
        n_class = br.read(6) + 1
        classbook = br.read(8)
        cascades = []
        for _ in range(n_class):
            low = br.read(3)
            high = br.read(5) if br.read_flag() else 0
            cascades.append(high << 3 | low)
        books = []
        for c in cascades:
            row = [br.read(8) if c & (1 << p) else -1
                   for p in range(8)]
            books.append(row)
        return Residue(rtype, begin, end, part_size, n_class,
                       classbook, books)

    def decode(self, br: BitReader, codebooks, do_decode: list,
               n2: int) -> np.ndarray:
        ch = len(do_decode)
        if self.rtype == 2:
            vec = self._decode_inner(br, codebooks,
                                     [any(do_decode)], n2 * ch)
            out = np.zeros((ch, n2), np.float32)
            for c in range(ch):
                out[c] = vec[0][c::ch]
            return out
        vecs = self._decode_inner(br, codebooks, do_decode, n2)
        return np.stack(vecs)

    def _decode_inner(self, br, codebooks, do_decode, size):
        ch = len(do_decode)
        out = [np.zeros(size, np.float32) for _ in range(ch)]
        begin = min(self.begin, size)
        end = min(self.end, size)
        n_read = end - begin
        if n_read <= 0:
            return out
        parts = n_read // self.part_size
        cbook = codebooks[self.classbook]
        cw = cbook.dims                      # classifications per word
        classes = [[0] * parts for _ in range(ch)]
        for p in range(8):                   # passes
            pc = 0
            while pc < parts:
                if p == 0:
                    for c in range(ch):
                        if not do_decode[c]:
                            continue
                        temp = cbook.decode(br)
                        for i in range(cw - 1, -1, -1):
                            if pc + i < parts:
                                classes[c][pc + i] = \
                                    temp % self.n_class
                            temp //= self.n_class
                for i in range(cw):
                    if pc >= parts:
                        break
                    for c in range(ch):
                        if not do_decode[c]:
                            continue
                        vq = self.books[classes[c][pc]][p]
                        if vq < 0:
                            continue
                        book = codebooks[vq]
                        off = begin + pc * self.part_size
                        if self.rtype == 0:
                            step = self.part_size // book.dims
                            for j in range(step):
                                v = book.decode_vq(br)
                                out[c][off + j:off + j
                                       + step * book.dims:step] += v
                        else:                # types 1 and 2
                            i2 = 0
                            while i2 < self.part_size:
                                v = book.decode_vq(br)
                                out[c][off + i2:off + i2
                                       + book.dims] += v
                                i2 += book.dims
                    pc += 1
        return out


# -- top-level decoder -------------------------------------------------------

@dataclass
class Mapping:
    mux: list
    submap_floor: list
    submap_residue: list
    coupling: list                          # (magnitude, angle)


class VorbisDecoder:
    """Feed the 3 header packets, then audio packets via decode()."""

    def __init__(self):
        self._ident = False
        self._setup = False
        self.channels = 0
        self.rate = 0
        self._imdct = {}
        self._windows = {}
        self._prev = None                   # (n_prev,)
        self._buf: np.ndarray | None = None
        self._out: list[np.ndarray] = []

    # -- headers ----------------------------------------------------------
    def header_packet(self, pkt: bytes) -> None:
        if pkt[1:7] != b"vorbis":
            raise ValueError("not a vorbis header")
        br = BitReader(pkt[7:])
        if pkt[0] == 1:
            if br.read(32) != 0:
                raise ValueError("unknown vorbis version")
            self.channels = br.read(8)
            self.rate = br.read(32)
            br.read(32), br.read(32), br.read(32)  # bitrates
            self.bs0 = 1 << br.read(4)
            self.bs1 = 1 << br.read(4)
            if not br.read_flag():
                raise ValueError("framing error")
            self._ident = True
        elif pkt[0] == 3:
            pass                             # comments: ignored
        elif pkt[0] == 5:
            self._parse_setup(br)
            self._setup = True

    def _parse_setup(self, br: BitReader) -> None:
        self.codebooks = [Codebook(br)
                          for _ in range(br.read(8) + 1)]
        for _ in range(br.read(6) + 1):      # time transforms
            if br.read(16) != 0:
                raise ValueError("bad time transform")
        self.floors = []
        for _ in range(br.read(6) + 1):
            ft = br.read(16)
            if ft != 1:
                raise ValueError(f"floor type {ft} unsupported "
                                 "(floor0 not implemented)")
            self.floors.append(Floor1.parse(br))
        self.residues = []
        for _ in range(br.read(6) + 1):
            rt = br.read(16)
            if rt > 2:
                raise ValueError(f"bad residue type {rt}")
            self.residues.append(Residue.parse(br, rt))
        self.mappings = []
        for _ in range(br.read(6) + 1):
            if br.read(16) != 0:
                raise ValueError("bad mapping type")
            submaps = br.read(4) + 1 if br.read_flag() else 1
            coupling = []
            if br.read_flag():
                for _ in range(br.read(8) + 1):
                    m = br.read(ilog(self.channels - 1))
                    a = br.read(ilog(self.channels - 1))
                    coupling.append((m, a))
            if br.read(2) != 0:
                raise ValueError("mapping reserved bits set")
            if submaps > 1:
                mux = [br.read(4) for _ in range(self.channels)]
            else:
                mux = [0] * self.channels
            sf, sr = [], []
            for _ in range(submaps):
                br.read(8)
                sf.append(br.read(8))
                sr.append(br.read(8))
            self.mappings.append(Mapping(mux, sf, sr, coupling))
        self.modes = []
        for _ in range(br.read(6) + 1):
            blockflag = br.read_flag()
            if br.read(16) or br.read(16):
                raise ValueError("bad mode transform")
            self.modes.append((blockflag, br.read(8)))
        if not br.read_flag():
            raise ValueError("setup framing error")

    # -- transforms ---------------------------------------------------------
    def _imdct_mat(self, n: int) -> np.ndarray:
        m = self._imdct.get(n)
        if m is None:
            k = np.arange(n // 2)
            i = np.arange(n)
            m = np.cos(np.pi / (2 * n)
                       * np.outer(2 * i + 1 + n / 2, 2 * k + 1)
                       ).astype(np.float32)
            self._imdct[n] = m
        return m

    def _window_slope(self, ln: int) -> np.ndarray:
        w = self._windows.get(ln)
        if w is None:
            x = (np.arange(ln) + 0.5) / ln * (np.pi / 2)
            w = np.sin(np.pi / 2 * np.sin(x) ** 2).astype(np.float32)
            self._windows[ln] = w
        return w

    # -- audio packets --------------------------------------------------------
    def decode(self, pkt: bytes) -> None:
        br = BitReader(pkt)
        if br.read(1):
            raise ValueError("not an audio packet")
        blockflag, mapping_no = self.modes[
            br.read(ilog(len(self.modes) - 1))]
        n = self.bs1 if blockflag else self.bs0
        prev_flag = next_flag = True
        if blockflag:
            prev_flag = br.read_flag()
            next_flag = br.read_flag()
        mapping = self.mappings[mapping_no]
        n2 = n // 2
        # floors
        floors_ys = []
        no_residue = []
        for c in range(self.channels):
            fl = self.floors[mapping.submap_floor[mapping.mux[c]]]
            ys = fl.decode(br, self.codebooks)
            floors_ys.append(ys)
            no_residue.append(ys is None)
        # coupling: a coupled pair decodes if either side does
        for m, a in mapping.coupling:
            if not (no_residue[m] and no_residue[a]):
                no_residue[m] = no_residue[a] = False
        # residues per submap
        spectra = np.zeros((self.channels, n2), np.float32)
        n_sub = len(mapping.submap_residue)
        for s in range(n_sub):
            chans = [c for c in range(self.channels)
                     if mapping.mux[c] == s]
            do = [not no_residue[c] for c in chans]
            res = self.residues[mapping.submap_residue[s]]
            dec = res.decode(br, self.codebooks, do, n2)
            for i, c in enumerate(chans):
                spectra[c] = dec[i]
        # inverse coupling (square polar, spec 4.3.6)
        for m, a in reversed(mapping.coupling):
            M, A = spectra[m].copy(), spectra[a].copy()
            new_m = np.where(M > 0,
                             np.where(A > 0, M, M + A),
                             np.where(A > 0, M, M - A))
            new_a = np.where(M > 0,
                             np.where(A > 0, M - A, M),
                             np.where(A > 0, M + A, M))
            spectra[m], spectra[a] = new_m, new_a
        # apply floor
        for c in range(self.channels):
            if no_residue[c] or floors_ys[c] is None:
                spectra[c] = 0.0
                continue
            fl = self.floors[mapping.submap_floor[mapping.mux[c]]]
            spectra[c] *= fl.curve(floors_ys[c], n2)
        # IMDCT + window
        mat = self._imdct_mat(n)
        time = spectra @ mat.T               # (ch, n)
        win = self._block_window(n, blockflag, prev_flag, next_flag)
        time *= win
        self._overlap_add(time, n, blockflag, prev_flag)

    def _block_window(self, n, blockflag, prev_flag, next_flag):
        w = np.zeros(n, np.float32)
        n2 = n // 2
        if blockflag and not prev_flag:
            ln = self.bs0 // 2
            lws = n // 4 - self.bs0 // 4
        else:
            ln = n2
            lws = 0
        if blockflag and not next_flag:
            rn = self.bs0 // 2
            rws = 3 * n // 4 - self.bs0 // 4
        else:
            rn = n2
            rws = n2
        w[lws:lws + ln] = self._window_slope(ln)
        w[lws + ln:rws] = 1.0
        w[rws:rws + rn] = self._window_slope(rn)[::-1]
        self._last_rws = rws
        return w

    def _overlap_add(self, time, n, blockflag, prev_flag):
        if self._prev is None:
            self._buf = time.copy()
            self._first_n = n
            self._prev = (n,)
            return
        n_prev = self._prev[0]
        # next block start offset (see spec window alignment):
        # centers advance by 3*n_prev/4 - n/4 relative placement
        adv = 3 * n_prev // 4 - n // 4
        old = self._buf
        need = adv + n
        if old.shape[1] < need:
            pad = np.zeros((old.shape[0], need - old.shape[1]),
                           np.float32)
            old = np.concatenate([old, pad], axis=1)
        old[:, adv:adv + n] += time
        # samples before the current block's left boundary are final
        final = old[:, :adv]
        if final.shape[1]:
            self._out.append(final.copy())
        self._buf = old[:, adv:].copy()
        self._prev = (n,)

    def finish(self, granulepos: int | None = None) -> np.ndarray:
        """-> (channels, samples) float32.  Output starts at the
        center of the first block (nothing before it is fully
        reconstructed) and is clipped to granulepos samples."""
        parts = list(self._out)
        if self._buf is not None:
            parts.append(self._buf)
        pcm = np.concatenate(parts, axis=1) if parts else \
            np.zeros((self.channels, 0), np.float32)
        start = getattr(self, "_first_n", 0) // 2
        pcm = pcm[:, start:]
        if granulepos is not None and 0 <= granulepos < pcm.shape[1]:
            pcm = pcm[:, :granulepos]
        return pcm


def decode_ogg_vorbis(data: bytes):
    """Whole-file helper -> (pcm (ch, n) float32, rate)."""
    from gstpu_torch.codecs.ogg import packets_of
    dec = VorbisDecoder()
    n_hdr = 0
    last_granule = -1
    for pkt, granule in packets_of(data):
        if n_hdr < 3:
            dec.header_packet(pkt)
            n_hdr += 1
            continue
        dec.decode(pkt)
        if granule > last_granule:
            last_granule = granule
    pcm = dec.finish(last_granule if last_granule >= 0 else None)
    return pcm, dec.rate
