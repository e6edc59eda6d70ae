"""SRTP (RFC 3711): AES-128-CM + HMAC-SHA1-80.

Backs webrtcsend/webrtcrecv (the reference webrtcbin2's srtpenc/
srtpdec path).  Key derivation, counter-mode keystream and
authentication follow RFC 3711 §4; the DTLS-SRTP handshake that
yields master keys has no counterpart in this environment, so keys
are injected directly (like srtpenc's `key` property).

The port's copy of gstpu/net/srtp.py, as it stands.
"""

from __future__ import annotations

import hmac
import hashlib

from cryptography.hazmat.primitives.ciphers import (Cipher,
                                                    algorithms, modes)

from gstpu_torch.net.replay import ReplayWindow

AUTH_TAG_LEN = 10                      # HMAC-SHA1-80


def _aes_ctr(key: bytes, iv16: bytes, data_len: int) -> bytes:
    enc = Cipher(algorithms.AES(key), modes.CTR(iv16)).encryptor()
    return enc.update(b"\x00" * data_len) + enc.finalize()


def _derive(master_key: bytes, master_salt: bytes, label: int,
            n: int) -> bytes:
    """RFC 3711 §4.3.1 key derivation (kdr = 0): key_id =
    label || (index DIV kdr) occupies the low 7 bytes of the
    14-byte salt, so the label lands 48 bits up."""
    x = int.from_bytes(master_salt, "big") ^ (label << 48)
    iv = (x << 16).to_bytes(16, "big")
    return _aes_ctr(master_key, iv, n)


def derive_session_keys(master_key: bytes, master_salt: bytes,
                        *, rtcp: bool = False):
    """-> (cipher_key 16, auth_key 20, session_salt 14)."""
    base = 3 if rtcp else 0
    return (_derive(master_key, master_salt, base + 0, 16),
            _derive(master_key, master_salt, base + 1, 20),
            _derive(master_key, master_salt, base + 2, 14))


class SrtpContext:
    """Per-direction SRTP context with ROC tracking."""

    def __init__(self, master_key: bytes, master_salt: bytes):
        if len(master_key) != 16 or len(master_salt) != 14:
            raise ValueError("AES_CM_128 needs 16B key + 14B salt")
        self.ck, self.ak, self.salt = derive_session_keys(
            master_key, master_salt)
        self._roc: dict[int, int] = {}     # ssrc -> rollover counter
        self._last_seq: dict[int, int] = {}
        # RFC 3711 §3.3.2 mandates a replay list per SSRC; indices
        # are accepted into the window only after authentication
        self._replay: dict[int, ReplayWindow] = {}

    # -- packet index -----------------------------------------------------
    def _index(self, ssrc: int, seq: int, *, sender: bool) -> int:
        roc = self._roc.get(ssrc, 0)
        last = self._last_seq.get(ssrc)
        if sender:
            if last is not None and seq < last and last - seq > 0x8000:
                roc += 1
                self._roc[ssrc] = roc
            self._last_seq[ssrc] = seq
            return roc << 16 | seq
        return self._estimate_index(ssrc, seq)

    def _estimate_index(self, ssrc: int, seq: int) -> int:
        """Receiver-side RFC 3711 §3.3.1 index estimation — PURE:
        does not touch _roc/_last_seq.  State is committed only after
        the auth tag verifies (RFC 3711 §3.3.1: update s_l and ROC
        only after authentication), so a forged packet near the
        16-bit wrap cannot poison the ROC."""
        roc = self._roc.get(ssrc, 0)
        last = self._last_seq.get(ssrc)
        if last is None:
            v = roc
        elif last < 0x8000:
            v = roc - 1 if seq - last > 0x8000 else roc
        else:
            v = roc + 1 if last - seq > 0x8000 else roc
        return max(v, 0) << 16 | seq

    def _commit_recv(self, ssrc: int, seq: int, index: int) -> None:
        roc = self._roc.get(ssrc, 0)
        last = self._last_seq.get(ssrc)
        v = index >> 16
        if last is None or seq > last or (last - seq) > 0x8000:
            self._last_seq[ssrc] = seq
            if v > roc:
                self._roc[ssrc] = v

    def _keystream(self, ssrc: int, index: int, n: int) -> bytes:
        iv = ((int.from_bytes(self.salt, "big") << 16)
              ^ (ssrc << 64) ^ (index << 16)).to_bytes(16, "big")
        return _aes_ctr(self.ck, iv, n)

    # -- protect / unprotect -----------------------------------------------
    def protect(self, rtp: bytes) -> bytes:
        hdr_len = 12 + 4 * (rtp[0] & 0x0F)
        if rtp[0] & 0x10:                  # extension header
            hdr_len += 4 + 4 * int.from_bytes(
                rtp[hdr_len + 2:hdr_len + 4], "big")
        ssrc = int.from_bytes(rtp[8:12], "big")
        seq = int.from_bytes(rtp[2:4], "big")
        index = self._index(ssrc, seq, sender=True)
        ks = self._keystream(ssrc, index, len(rtp) - hdr_len)
        body = bytes(a ^ b for a, b in zip(rtp[hdr_len:], ks))
        pkt = rtp[:hdr_len] + body
        roc = index >> 16
        tag = hmac.new(self.ak, pkt + roc.to_bytes(4, "big"),
                       hashlib.sha1).digest()[:AUTH_TAG_LEN]
        return pkt + tag

    def unprotect(self, srtp: bytes) -> bytes:
        if len(srtp) < 12 + AUTH_TAG_LEN:
            raise ValueError("srtp packet too short")
        pkt, tag = srtp[:-AUTH_TAG_LEN], srtp[-AUTH_TAG_LEN:]
        ssrc = int.from_bytes(pkt[8:12], "big")
        seq = int.from_bytes(pkt[2:4], "big")
        index = self._estimate_index(ssrc, seq)
        window = self._replay.setdefault(ssrc, ReplayWindow())
        if window.is_replay(index):
            raise ValueError("srtp replay")
        roc = index >> 16
        want = hmac.new(self.ak, pkt + roc.to_bytes(4, "big"),
                        hashlib.sha1).digest()[:AUTH_TAG_LEN]
        if not hmac.compare_digest(tag, want):
            raise ValueError("srtp auth failure")
        window.accept(index)
        self._commit_recv(ssrc, seq, index)
        hdr_len = 12 + 4 * (pkt[0] & 0x0F)
        if pkt[0] & 0x10:
            hdr_len += 4 + 4 * int.from_bytes(
                pkt[hdr_len + 2:hdr_len + 4], "big")
        ks = self._keystream(ssrc, index, len(pkt) - hdr_len)
        body = bytes(a ^ b for a, b in zip(pkt[hdr_len:], ks))
        return pkt[:hdr_len] + body


class SrtcpContext:
    """Per-direction SRTCP (RFC 3711 §3.4): the full RTCP packet
    after the first 8 bytes is encrypted; a 4-byte E||index word and
    the auth tag are appended. Keys derive with the RTCP labels
    (3/4/5)."""

    def __init__(self, master_key: bytes, master_salt: bytes):
        if len(master_key) != 16 or len(master_salt) != 14:
            raise ValueError("AES_CM_128 needs 16B key + 14B salt")
        self.ck, self.ak, self.salt = derive_session_keys(
            master_key, master_salt, rtcp=True)
        self._send_index = 0
        self._replay = ReplayWindow()

    def _keystream(self, ssrc: int, index: int, n: int) -> bytes:
        iv = ((int.from_bytes(self.salt, "big") << 16)
              ^ (ssrc << 64) ^ (index << 16)).to_bytes(16, "big")
        return _aes_ctr(self.ck, iv, n)

    def protect(self, rtcp: bytes) -> bytes:
        if len(rtcp) < 8:
            raise ValueError("rtcp packet too short")
        ssrc = int.from_bytes(rtcp[4:8], "big")
        index = self._send_index
        self._send_index = (self._send_index + 1) & 0x7FFFFFFF
        ks = self._keystream(ssrc, index, len(rtcp) - 8)
        body = bytes(a ^ b for a, b in zip(rtcp[8:], ks))
        e_index = (0x80000000 | index).to_bytes(4, "big")
        pkt = rtcp[:8] + body + e_index
        tag = hmac.new(self.ak, pkt, hashlib.sha1) \
            .digest()[:AUTH_TAG_LEN]
        return pkt + tag

    def unprotect(self, srtcp: bytes) -> bytes:
        if len(srtcp) < 8 + 4 + AUTH_TAG_LEN:
            raise ValueError("srtcp packet too short")
        pkt, tag = srtcp[:-AUTH_TAG_LEN], srtcp[-AUTH_TAG_LEN:]
        e_index = int.from_bytes(pkt[-4:], "big")
        encrypted = bool(e_index & 0x80000000)
        index = e_index & 0x7FFFFFFF
        if self._replay.is_replay(index):
            raise ValueError("srtcp replay")
        want = hmac.new(self.ak, pkt, hashlib.sha1) \
            .digest()[:AUTH_TAG_LEN]
        if not hmac.compare_digest(tag, want):
            raise ValueError("srtcp auth failure")
        self._replay.accept(index)
        body = pkt[8:-4]
        if encrypted:
            ssrc = int.from_bytes(pkt[4:8], "big")
            ks = self._keystream(ssrc, index, len(body))
            body = bytes(a ^ b for a, b in zip(body, ks))
        return pkt[:8] + body
