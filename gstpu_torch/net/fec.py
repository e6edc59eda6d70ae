"""GF(256) Reed-Solomon erasure coding for RTP FEC.

Backs the raptorqenc/raptorqdec elements.  The reference wraps the
raptorq crate (RFC 6330); reproducing that spec bit-for-bit needs its
permanent K'/J(K') tables, so this implementation keeps the same
element model (source block -> repair symbols -> recover any k of
k+r) with a systematic Vandermonde Reed-Solomon code instead — same
recovery guarantees, NOT wire-compatible with RFC 6330 (flagged in
PARITY.md like the sodium elements).

The port's copy of gstpu/net/fec.py, as it stands.
"""

from __future__ import annotations

# GF(2^8) with the AES/RS polynomial 0x11D, generator 2
_EXP = [0] * 512
_LOG = [0] * 256
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= 0x11D
for _i in range(255, 512):
    _EXP[_i] = _EXP[_i - 255]


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return _EXP[_LOG[a] + _LOG[b]]


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("gf_inv(0)")
    return _EXP[255 - _LOG[a]]


def _row_mul_add(dst: bytearray, src: bytes, c: int) -> None:
    if c == 0:
        return
    lc = _LOG[c]
    for i, s in enumerate(src):
        if s:
            dst[i] ^= _EXP[_LOG[s] + lc]


def _vandermonde_row(esi: int, k: int) -> list[int]:
    """Repair row for encoding symbol id esi (>= k): alpha^(esi*j)."""
    return [_EXP[(esi * j) % 255] for j in range(k)]


def encode_repair(source: list[bytes], n_repair: int) -> list[bytes]:
    """source: k equal-length symbols -> n_repair parity symbols."""
    k = len(source)
    size = len(source[0])
    assert all(len(s) == size for s in source)
    out = []
    for r in range(n_repair):
        row = _vandermonde_row(k + r, k)
        acc = bytearray(size)
        for j, c in enumerate(row):
            _row_mul_add(acc, source[j], c)
        out.append(bytes(acc))
    return out


def decode_block(k: int, received: dict[int, bytes]) -> list[bytes]:
    """received: esi -> symbol (esi < k source, >= k repair).  Returns
    the k source symbols; raises ValueError if fewer than k symbols.
    """
    if len(received) < k:
        raise ValueError(f"need {k} symbols, have {len(received)}")
    have_src = {e: s for e, s in received.items() if e < k}
    if len(have_src) == k:
        return [have_src[i] for i in range(k)]
    # build the linear system: each received symbol = row . source
    esis = sorted(received)[:k]
    size = len(received[esis[0]])
    rows = []
    vals = []
    for e in esis:
        if e < k:
            rows.append([1 if j == e else 0 for j in range(k)])
        else:
            rows.append(_vandermonde_row(e, k))
        vals.append(bytearray(received[e]))
    # gaussian elimination over GF(256)
    for col in range(k):
        piv = next((r for r in range(col, k) if rows[r][col]), None)
        if piv is None:
            raise ValueError("singular FEC matrix (symbol overlap)")
        rows[col], rows[piv] = rows[piv], rows[col]
        vals[col], vals[piv] = vals[piv], vals[col]
        inv = gf_inv(rows[col][col])
        rows[col] = [gf_mul(c, inv) for c in rows[col]]
        v = vals[col]
        if inv != 1:
            li = _LOG[inv]
            for i, b in enumerate(v):
                if b:
                    v[i] = _EXP[_LOG[b] + li]
        for r in range(k):
            if r != col and rows[r][col]:
                c = rows[r][col]
                rows[r] = [a ^ gf_mul(c, b)
                           for a, b in zip(rows[r], rows[col])]
                _row_mul_add(vals[r], bytes(vals[col]), c)
    return [bytes(v) for v in vals]
