"""TLS 1.3 handshake machine for QUIC (RFC 8446 as profiled by
RFC 9001): no record layer — raw handshake messages ride QUIC CRYPTO
frames per encryption level, and the traffic secrets hand QUIC its
packet-protection keys.

Covers the WebRTC-style profile the quinn elements need:
TLS_AES_128_GCM_SHA256, P-256 ECDHE key share, self-signed ECDSA
certificates with SHA-256 fingerprint pinning, ALPN, and the
quic_transport_parameters extension.

The port's copy of gstpu/net/quic/tls13.py, as it stands.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import struct

from cryptography.exceptions import InvalidSignature
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec

from gstpu_torch.net.quic.packet import QuicError, hkdf_expand_label, \
    hkdf_extract
from gstpu_torch.net.webrtc.dtls import fingerprint, generate_certificate

# levels (match QUIC packet spaces)
INITIAL, HANDSHAKE, APPLICATION = 0, 1, 2

HT_CLIENT_HELLO = 1
HT_SERVER_HELLO = 2
HT_ENCRYPTED_EXTENSIONS = 8
HT_CERTIFICATE = 11
HT_CERTIFICATE_VERIFY = 15
HT_FINISHED = 20

SUITE_AES128_GCM_SHA256 = 0x1301
SIGALG_ECDSA_P256_SHA256 = 0x0403
GROUP_P256 = 0x0017

EXT_SERVER_NAME = 0x0000
EXT_SUPPORTED_GROUPS = 0x000A
EXT_SIG_ALGS = 0x000D
EXT_ALPN = 0x0010
EXT_SUPPORTED_VERSIONS = 0x002B
EXT_KEY_SHARE = 0x0033
EXT_QUIC_TRANSPORT_PARAMS = 0x0039

_CV_CONTEXT_SERVER = (b" " * 64
                      + b"TLS 1.3, server CertificateVerify" + b"\x00")


class TlsError(QuicError):
    pass


def _msg(ht: int, body: bytes) -> bytes:
    return bytes([ht]) + len(body).to_bytes(3, "big") + body


def _ext(et: int, body: bytes) -> bytes:
    return struct.pack(">HH", et, len(body)) + body


def _derive_secret(secret: bytes, label: bytes,
                   transcript: bytes) -> bytes:
    return hkdf_expand_label(secret, label,
                             hashlib.sha256(transcript).digest(), 32)


def _parse_extensions(data: bytes) -> dict[int, bytes]:
    out = {}
    pos = 0
    while pos + 4 <= len(data):
        et, ln = struct.unpack_from(">HH", data, pos)
        out[et] = data[pos + 4:pos + 4 + ln]
        pos += 4 + ln
    return out


class Tls13Machine:
    """Sans-IO TLS 1.3 for QUIC.

    Drive with feed(level, crypto_bytes); drain (level, bytes) from
    .outputs. Traffic secrets appear in .hs_secrets / .ap_secrets as
    (client_secret, server_secret) when ready; .complete flips once
    both Finished verify.
    """

    def __init__(self, *, client: bool, alpn: str = "gstpu-quic",
                 certificate=None,
                 remote_fingerprint: str | None = None,
                 transport_params: bytes = b""):
        self.is_client = client
        self.alpn = alpn
        if certificate is None:
            certificate = generate_certificate("gstpu-quic")
        self.key, self.cert = certificate
        self.remote_fingerprint = remote_fingerprint
        self.peer_cert = None
        self.transport_params = transport_params
        self.peer_transport_params: bytes | None = None
        self.outputs: list[tuple[int, bytes]] = []
        self.hs_secrets: tuple[bytes, bytes] | None = None
        self.ap_secrets: tuple[bytes, bytes] | None = None
        self.complete = False
        self._transcript = b""
        self._buf = {INITIAL: b"", HANDSHAKE: b"", APPLICATION: b""}
        self._ecdh = ec.generate_private_key(ec.SECP256R1())
        self._hs_secret = b""
        self._master = b""
        self._client_hs = self._server_hs = b""
        self._sent_finished = False

    @property
    def local_fingerprint(self) -> str:
        return fingerprint(self.cert)

    # -- builders --------------------------------------------------------
    def _point(self) -> bytes:
        return self._ecdh.public_key().public_bytes(
            serialization.Encoding.X962,
            serialization.PublicFormat.UncompressedPoint)

    def start(self) -> None:
        """Client entry: emit the ClientHello at the Initial level."""
        assert self.is_client
        alpn = self.alpn.encode()
        exts = b"".join([
            _ext(EXT_SUPPORTED_VERSIONS, b"\x02\x03\x04"),
            _ext(EXT_SUPPORTED_GROUPS,
                 struct.pack(">HH", 2, GROUP_P256)),
            _ext(EXT_SIG_ALGS,
                 struct.pack(">HHH", 2, SIGALG_ECDSA_P256_SHA256,
                             0)[:4]),
            _ext(EXT_KEY_SHARE,
                 struct.pack(">HHH", 4 + len(self._point()),
                             GROUP_P256, len(self._point()))
                 + self._point()),
            _ext(EXT_ALPN, struct.pack(">H", len(alpn) + 1)
                 + bytes([len(alpn)]) + alpn),
            _ext(EXT_QUIC_TRANSPORT_PARAMS, self.transport_params),
        ])
        body = (b"\x03\x03" + os.urandom(32)
                + b"\x00"                          # empty session id
                + struct.pack(">HH", 2, SUITE_AES128_GCM_SHA256)
                + b"\x01\x00"
                + struct.pack(">H", len(exts)) + exts)
        self._emit(INITIAL, HT_CLIENT_HELLO, body)

    def _emit(self, level: int, ht: int, body: bytes) -> None:
        m = _msg(ht, body)
        self._transcript += m
        self.outputs.append((level, m))

    # -- feeding ----------------------------------------------------------
    def feed(self, level: int, data: bytes) -> None:
        self._buf[level] += data
        buf = self._buf[level]
        pos = 0
        while pos + 4 <= len(buf):
            ln = int.from_bytes(buf[pos + 1:pos + 4], "big")
            if pos + 4 + ln > len(buf):
                break
            ht = buf[pos]
            body = buf[pos + 4:pos + 4 + ln]
            raw = buf[pos:pos + 4 + ln]
            pos += 4 + ln
            self._handle(level, ht, body, raw)
        self._buf[level] = buf[pos:]

    # -- key schedule -------------------------------------------------------
    def _schedule_handshake(self, peer_point: bytes) -> None:
        peer = ec.EllipticCurvePublicKey.from_encoded_point(
            ec.SECP256R1(), peer_point)
        shared = self._ecdh.exchange(ec.ECDH(), peer)
        early = hkdf_extract(b"\x00" * 32, b"\x00" * 32)
        derived = _derive_secret(early, b"derived", b"")
        self._hs_secret = hkdf_extract(derived, shared)
        self._client_hs = _derive_secret(self._hs_secret,
                                         b"c hs traffic",
                                         self._transcript)
        self._server_hs = _derive_secret(self._hs_secret,
                                         b"s hs traffic",
                                         self._transcript)
        self.hs_secrets = (self._client_hs, self._server_hs)
        derived2 = _derive_secret(self._hs_secret, b"derived", b"")
        self._master = hkdf_extract(derived2, b"\x00" * 32)

    def _schedule_application(self) -> None:
        cap = _derive_secret(self._master, b"c ap traffic",
                             self._transcript)
        sap = _derive_secret(self._master, b"s ap traffic",
                             self._transcript)
        self.ap_secrets = (cap, sap)

    def _finished_data(self, secret: bytes) -> bytes:
        fk = hkdf_expand_label(secret, b"finished", b"", 32)
        return hmac.new(fk, hashlib.sha256(self._transcript).digest(),
                        hashlib.sha256).digest()

    # -- certificate plumbing -------------------------------------------------
    def _cert_msg_body(self) -> bytes:
        der = self.cert.public_bytes(serialization.Encoding.DER)
        entry = len(der).to_bytes(3, "big") + der + b"\x00\x00"
        return b"\x00" + len(entry).to_bytes(3, "big") + entry

    def _check_peer_cert(self, body: bytes) -> None:
        from cryptography import x509
        pos = 1 + 3                     # context + list length
        ln = int.from_bytes(body[pos:pos + 3], "big")
        der = body[pos + 3:pos + 3 + ln]
        self.peer_cert = x509.load_der_x509_certificate(der)
        if self.remote_fingerprint is not None:
            got = fingerprint(self.peer_cert)
            norm = lambda s: s.lower().replace(" ", "")
            if norm(got) != norm(self.remote_fingerprint):
                raise TlsError("certificate fingerprint mismatch")

    # -- message handling -------------------------------------------------------
    def _handle(self, level: int, ht: int, body: bytes,
                raw: bytes) -> None:
        if self.is_client:
            self._handle_client(level, ht, body, raw)
        else:
            self._handle_server(level, ht, body, raw)

    def _handle_server(self, level, ht, body, raw) -> None:
        if ht == HT_CLIENT_HELLO and level == INITIAL:
            self._transcript += raw
            sid_len = body[34]
            pos = 35 + sid_len
            cs_len, = struct.unpack_from(">H", body, pos)
            pos += 2 + cs_len
            pos += 1 + body[pos]        # compression
            ext_len, = struct.unpack_from(">H", body, pos)
            exts = _parse_extensions(body[pos + 2:pos + 2 + ext_len])
            ks = exts.get(EXT_KEY_SHARE)
            if ks is None:
                raise TlsError("no key_share")
            # client share list: len(2) group(2) klen(2) point
            point = ks[6:6 + struct.unpack_from(">H", ks, 4)[0]]
            self.peer_transport_params = exts.get(
                EXT_QUIC_TRANSPORT_PARAMS)
            # ServerHello
            sh_exts = b"".join([
                _ext(EXT_SUPPORTED_VERSIONS, b"\x03\x04"),
                _ext(EXT_KEY_SHARE,
                     struct.pack(">HH", GROUP_P256,
                                 len(self._point()))
                     + self._point()),
            ])
            sh = (b"\x03\x03" + os.urandom(32)
                  + bytes([sid_len]) + body[35:35 + sid_len]
                  + struct.pack(">H", SUITE_AES128_GCM_SHA256)
                  + b"\x00"
                  + struct.pack(">H", len(sh_exts)) + sh_exts)
            self._emit(INITIAL, HT_SERVER_HELLO, sh)
            self._schedule_handshake(point)
            # EncryptedExtensions + Certificate + CertificateVerify +
            # Finished, all at the handshake level
            alpn = self.alpn.encode()
            ee = b"".join([
                _ext(EXT_ALPN, struct.pack(">H", len(alpn) + 1)
                     + bytes([len(alpn)]) + alpn),
                _ext(EXT_QUIC_TRANSPORT_PARAMS,
                     self.transport_params),
            ])
            self._emit(HANDSHAKE, HT_ENCRYPTED_EXTENSIONS,
                       struct.pack(">H", len(ee)) + ee)
            self._emit(HANDSHAKE, HT_CERTIFICATE,
                       self._cert_msg_body())
            tbs = (_CV_CONTEXT_SERVER
                   + hashlib.sha256(self._transcript).digest())
            sig = self.key.sign(tbs, ec.ECDSA(hashes.SHA256()))
            self._emit(HANDSHAKE, HT_CERTIFICATE_VERIFY,
                       struct.pack(">HH", SIGALG_ECDSA_P256_SHA256,
                                   len(sig)) + sig)
            verify = self._finished_data(self._server_hs)
            self._emit(HANDSHAKE, HT_FINISHED, verify)
            # server application keys are usable once Finished is sent
            self._schedule_application()
        elif ht == HT_FINISHED and level == HANDSHAKE:
            if not self._master:
                raise TlsError("Finished before key exchange")
            want = self._finished_data(self._client_hs)
            if not hmac.compare_digest(body, want):
                raise TlsError("client Finished mismatch")
            self._transcript += raw
            self.complete = True
        else:
            raise TlsError(f"unexpected message {ht} at level {level}")

    def _handle_client(self, level, ht, body, raw) -> None:
        if ht == HT_SERVER_HELLO and level == INITIAL:
            self._transcript += raw
            suite, = struct.unpack_from(">H", body, 35 + body[34])
            if suite != SUITE_AES128_GCM_SHA256:
                raise TlsError(f"unexpected suite {suite:#x}")
            pos = 35 + body[34] + 2 + 1
            ext_len, = struct.unpack_from(">H", body, pos)
            exts = _parse_extensions(body[pos + 2:pos + 2 + ext_len])
            ks = exts.get(EXT_KEY_SHARE)
            if ks is None:
                raise TlsError("no key_share in ServerHello")
            point = ks[4:4 + struct.unpack_from(">H", ks, 2)[0]]
            self._schedule_handshake(point)
        elif ht == HT_ENCRYPTED_EXTENSIONS and level == HANDSHAKE:
            self._transcript += raw
            ln, = struct.unpack_from(">H", body, 0)
            exts = _parse_extensions(body[2:2 + ln])
            self.peer_transport_params = exts.get(
                EXT_QUIC_TRANSPORT_PARAMS)
        elif ht == HT_CERTIFICATE and level == HANDSHAKE:
            self._check_peer_cert(body)
            self._transcript += raw
        elif ht == HT_CERTIFICATE_VERIFY and level == HANDSHAKE:
            if self.peer_cert is None:
                raise TlsError("CertificateVerify without Certificate")
            siglen, = struct.unpack_from(">H", body, 2)
            sig = body[4:4 + siglen]
            tbs = (_CV_CONTEXT_SERVER
                   + hashlib.sha256(self._transcript).digest())
            try:
                self.peer_cert.public_key().verify(
                    sig, tbs, ec.ECDSA(hashes.SHA256()))
            except InvalidSignature as e:
                raise TlsError("bad CertificateVerify") from e
            self._transcript += raw
        elif ht == HT_FINISHED and level == HANDSHAKE:
            if not self._master or self.peer_cert is None:
                raise TlsError("Finished before authentication")
            want = self._finished_data(self._server_hs)
            if not hmac.compare_digest(body, want):
                raise TlsError("server Finished mismatch")
            self._transcript += raw
            # client application keys use the transcript through the
            # server Finished
            self._schedule_application()
            verify = self._finished_data(self._client_hs)
            self._emit(HANDSHAKE, HT_FINISHED, verify)
            self._sent_finished = True
            self.complete = True
        else:
            raise TlsError(f"unexpected message {ht} at level {level}")
