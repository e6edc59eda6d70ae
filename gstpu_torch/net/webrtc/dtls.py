"""Sans-IO DTLS 1.2 endpoint with DTLS-SRTP keying (RFC 6347 +
RFC 5764).

The reference's webrtcbin2 gets DTLS from str0m; this rebuilds the
handshake from the RFCs on the `cryptography` primitives:

- cipher suite TLS_ECDHE_ECDSA_WITH_AES_128_GCM_SHA256 with
  self-signed P-256 certificates (the WebRTC norm)
- cookie exchange (HelloVerifyRequest), mutual certificate auth
  (CertificateRequest/CertificateVerify) and fingerprint pinning
  against the SDP `a=fingerprint` value
- the use_srtp extension negotiating SRTP_AES128_CM_HMAC_SHA1_80 and
  the RFC 5705 exporter deriving the SRTP master keys/salts that
  feed gstpu_torch.net.srtp (webrtcsend/webrtcrecv)

Driving contract (like the ICE agent): handshake() starts a client,
handle_packet(datagram) ingests, poll_transmit() drains, and
`srtp_keys` is set once both Finished messages verify. No timers /
retransmission: WebRTC bundles run over ICE-verified paths and the
in-process tests are lossless; a lost-datagram deployment wraps this
in the element's retry loop.

The port's copy of gstpu/net/webrtc/dtls.py, as it stands.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import struct
from dataclasses import dataclass

from cryptography import x509
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec
from cryptography.hazmat.primitives.asymmetric.utils import (
    decode_dss_signature, encode_dss_signature)
from cryptography.hazmat.primitives.ciphers.aead import AESGCM

from gstpu_torch.net.replay import ReplayWindow

DTLS12 = 0xFEFD
CT_CCS, CT_ALERT, CT_HANDSHAKE, CT_APPDATA = 20, 21, 22, 23
HT_CLIENT_HELLO = 1
HT_SERVER_HELLO = 2
HT_HELLO_VERIFY = 3
HT_CERTIFICATE = 11
HT_SERVER_KEY_EXCHANGE = 12
HT_CERTIFICATE_REQUEST = 13
HT_SERVER_HELLO_DONE = 14
HT_CERTIFICATE_VERIFY = 15
HT_CLIENT_KEY_EXCHANGE = 16
HT_FINISHED = 20

SUITE_ECDHE_ECDSA_AES128_GCM_SHA256 = 0xC02B
EXT_SUPPORTED_GROUPS = 0x000A
EXT_EC_POINT_FORMATS = 0x000B
EXT_SIG_ALGS = 0x000D
EXT_USE_SRTP = 0x000E
GROUP_P256 = 0x0017
SIGALG_ECDSA_P256_SHA256 = 0x0403
SRTP_AES128_CM_SHA1_80 = 0x0001

SRTP_KEY_LEN, SRTP_SALT_LEN = 16, 14


class DtlsError(Exception):
    pass


def _prf(secret: bytes, label: bytes, seed: bytes, n: int) -> bytes:
    """TLS 1.2 PRF (P_SHA256)."""
    seed = label + seed
    out = b""
    a = seed
    while len(out) < n:
        a = hmac.new(secret, a, hashlib.sha256).digest()
        out += hmac.new(secret, a + seed, hashlib.sha256).digest()
    return out[:n]


def generate_certificate(cn: str = "gstpu-webrtc"):
    """Self-signed P-256 certificate (key, cert) like WebRTC stacks
    mint per-connection."""
    import datetime
    key = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name([x509.NameAttribute(
        x509.NameOID.COMMON_NAME, cn)])
    now = datetime.datetime(2024, 1, 1)
    cert = (x509.CertificateBuilder()
            .subject_name(name).issuer_name(name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now)
            .not_valid_after(now + datetime.timedelta(days=3650))
            .sign(key, hashes.SHA256()))
    return key, cert


def fingerprint(cert) -> str:
    """SDP a=fingerprint value: sha-256 AA:BB:..."""
    der = cert.public_bytes(serialization.Encoding.DER)
    dg = hashlib.sha256(der).digest()
    return "sha-256 " + ":".join(f"{b:02X}" for b in dg)


@dataclass
class SrtpKeys:
    """RFC 5764 §4.2 key material split."""
    client_key: bytes
    server_key: bytes
    client_salt: bytes
    server_salt: bytes

    def send_key_salt(self, is_client: bool) -> tuple[bytes, bytes]:
        return ((self.client_key, self.client_salt) if is_client
                else (self.server_key, self.server_salt))

    def recv_key_salt(self, is_client: bool) -> tuple[bytes, bytes]:
        return ((self.server_key, self.server_salt) if is_client
                else (self.client_key, self.client_salt))


def _handshake_msg(ht: int, seq: int, body: bytes) -> bytes:
    ln = len(body)
    return (struct.pack(">B", ht) + ln.to_bytes(3, "big")
            + struct.pack(">H", seq) + (0).to_bytes(3, "big")
            + ln.to_bytes(3, "big") + body)


def _ext(etype: int, body: bytes) -> bytes:
    return struct.pack(">HH", etype, len(body)) + body


def _raw_point(pub) -> bytes:
    return pub.public_bytes(
        serialization.Encoding.X962,
        serialization.PublicFormat.UncompressedPoint)


def _sig_to_der(sig: bytes) -> bytes:
    return sig  # cryptography already emits DER for ECDSA sign()


class DtlsEndpoint:
    """One side of a DTLS-SRTP association."""

    def __init__(self, *, client: bool, certificate=None,
                 remote_fingerprint: str | None = None):
        self.is_client = client
        if certificate is None:
            certificate = generate_certificate()
        self.key, self.cert = certificate
        self.remote_fingerprint = remote_fingerprint
        self.peer_cert = None
        self.srtp_keys: SrtpKeys | None = None
        self.srtp_profile: int | None = None
        self.connected = False

        self._outbox: list[bytes] = []
        self.app_inbox: list[bytes] = []
        self._epoch = 0
        self._seq = 0
        self._msg_seq = 0
        self._peer_epoch_1 = False
        self._transcript = b""     # handshake messages for hashes
        self._client_random = b""
        self._server_random = b""
        self._master = b""
        self._ecdh_priv = None
        self._peer_point = None
        self._cookie = b""
        self._cookie_secret = os.urandom(16)
        self._state = "new"
        self._keys = None          # (write_key, write_iv, read_key, read_iv)
        # per-epoch sliding replay window (advisor r2: a cleared-when-
        # full set re-enabled replay of every previously seen record)
        self._read_replay: dict[int, ReplayWindow] = {}

    @property
    def local_fingerprint(self) -> str:
        return fingerprint(self.cert)

    # -- record layer -------------------------------------------------------
    def _send_record(self, ctype: int, payload: bytes) -> None:
        if self._epoch == 1 and ctype != CT_CCS:
            payload = self._encrypt(ctype, payload)
        hdr = struct.pack(">BHH", ctype, DTLS12, self._epoch) \
            + self._seq.to_bytes(6, "big") \
            + struct.pack(">H", len(payload))
        self._outbox.append(hdr + payload)
        self._seq += 1

    def _send_handshake(self, ht: int, body: bytes,
                        transcript: bool = True) -> None:
        msg = _handshake_msg(ht, self._msg_seq, body)
        self._msg_seq += 1
        if transcript:
            self._transcript += msg
        self._send_record(CT_HANDSHAKE, msg)

    def _encrypt(self, ctype: int, plaintext: bytes) -> bytes:
        wkey, wiv = self._keys[0], self._keys[1]
        explicit = (struct.pack(">H", self._epoch)
                    + self._seq.to_bytes(6, "big"))
        nonce = wiv + explicit
        aad = (explicit + struct.pack(">BHH", ctype, DTLS12,
                                      len(plaintext)))
        ct = AESGCM(wkey).encrypt(nonce, plaintext, aad)
        return explicit + ct

    def _decrypt(self, ctype: int, data: bytes) -> bytes:
        rkey, riv = self._keys[2], self._keys[3]
        explicit, ct = data[:8], data[8:]
        nonce = riv + explicit
        aad = (explicit + struct.pack(">BHH", ctype, DTLS12,
                                      len(ct) - 16))
        return AESGCM(rkey).decrypt(nonce, ct, aad)

    def send_application(self, data: bytes) -> None:
        """Encrypt `data` as a DTLS application-data record
        (SCTP-over-DTLS rides here, RFC 8261)."""
        if self._keys is None:
            raise DtlsError("application data before handshake")
        self._send_record(CT_APPDATA, data)

    def poll_transmit(self) -> bytes | None:
        if self._outbox:
            return self._outbox.pop(0)
        return None

    # -- hello construction --------------------------------------------------
    def _extensions(self) -> bytes:
        exts = b""
        exts += _ext(EXT_SUPPORTED_GROUPS,
                     struct.pack(">HH", 2, GROUP_P256))
        exts += _ext(EXT_EC_POINT_FORMATS, b"\x01\x00")
        exts += _ext(EXT_SIG_ALGS,
                     struct.pack(">HH", 2, SIGALG_ECDSA_P256_SHA256))
        # use_srtp: one profile + empty MKI (RFC 5764 §4.1.1)
        exts += _ext(EXT_USE_SRTP,
                     struct.pack(">HH", 2, SRTP_AES128_CM_SHA1_80)
                     + b"\x00")
        return struct.pack(">H", len(exts)) + exts

    def _client_hello(self) -> bytes:
        return (struct.pack(">H", DTLS12) + self._client_random
                + b"\x00"                                  # session id
                + bytes([len(self._cookie)]) + self._cookie
                + struct.pack(">HH", 2,
                              SUITE_ECDHE_ECDSA_AES128_GCM_SHA256)
                + b"\x01\x00"                              # null compression
                + self._extensions())

    # -- public driving -------------------------------------------------------
    def handshake(self) -> None:
        """Client entry point: emit the first ClientHello."""
        assert self.is_client
        self._client_random = os.urandom(32)
        self._state = "wait_hvr"
        # first ClientHello (pre-cookie) is NOT in the Finished hash
        self._send_handshake(HT_CLIENT_HELLO, self._client_hello(),
                             transcript=False)

    def handle_packet(self, datagram: bytes) -> None:
        """Ingest one datagram. Malformed or forged input raises
        DtlsError (never bare struct/index/crypto errors), so drivers
        can drop bad datagrams without tearing down."""
        try:
            self._handle_datagram(datagram)
        except DtlsError:
            raise
        except Exception as e:
            raise DtlsError(f"malformed DTLS datagram: "
                            f"{type(e).__name__}: {e}") from e

    def _handle_datagram(self, datagram: bytes) -> None:
        pos = 0
        while pos + 13 <= len(datagram):
            ctype, ver, epoch = struct.unpack_from(">BHH", datagram,
                                                   pos)
            rseq = int.from_bytes(datagram[pos + 5:pos + 11], "big")
            ln, = struct.unpack_from(">H", datagram, pos + 11)
            payload = datagram[pos + 13:pos + 13 + ln]
            pos += 13 + ln
            window = self._read_replay.setdefault(
                epoch, ReplayWindow(size=1024))
            if window.is_replay(rseq):
                continue            # replayed record
            if epoch == 1:
                if self._keys is None:
                    raise DtlsError("epoch 1 before keys")
                # authenticate BEFORE marking the seq seen, so a
                # spoofed record can't block the genuine one
                payload = self._decrypt(ctype, payload)
            window.accept(rseq)
            if ctype == CT_CCS:
                self._peer_epoch_1 = True
                continue
            if ctype == CT_ALERT:
                raise DtlsError(f"DTLS alert: {payload.hex()}")
            if ctype == CT_APPDATA:
                if epoch == 1:          # only authenticated app data
                    self.app_inbox.append(payload)
                continue
            if ctype != CT_HANDSHAKE:
                continue
            self._handle_handshake_payload(payload)

    def _handle_handshake_payload(self, payload: bytes) -> None:
        pos = 0
        while pos + 12 <= len(payload):
            ht = payload[pos]
            ln = int.from_bytes(payload[pos + 1:pos + 4], "big")
            body = payload[pos + 12:pos + 12 + ln]
            raw = payload[pos:pos + 12 + ln]
            pos += 12 + ln
            self._dispatch(ht, body, raw)

    # -- message dispatch ------------------------------------------------------
    def _dispatch(self, ht: int, body: bytes, raw: bytes) -> None:
        if self.is_client:
            self._dispatch_client(ht, body, raw)
        else:
            self._dispatch_server(ht, body, raw)

    # ---- server side -----------------------------------------------------
    def _dispatch_server(self, ht: int, body: bytes,
                         raw: bytes) -> None:
        if ht == HT_CLIENT_HELLO:
            ch = _parse_client_hello(body)
            if not ch["cookie"]:
                # stateless cookie: HMAC over the client random
                cookie = hmac.new(self._cookie_secret, ch["random"],
                                  hashlib.sha256).digest()[:16]
                hvr = struct.pack(">H", DTLS12) \
                    + bytes([len(cookie)]) + cookie
                self._send_handshake(HT_HELLO_VERIFY, hvr,
                                     transcript=False)
                # HVR resets the transcript (RFC 6347 §4.2.1)
                self._transcript = b""
                return
            expect = hmac.new(self._cookie_secret, ch["random"],
                              hashlib.sha256).digest()[:16]
            if not hmac.compare_digest(ch["cookie"], expect):
                raise DtlsError("bad cookie")
            if SRTP_AES128_CM_SHA1_80 not in ch["srtp_profiles"]:
                raise DtlsError("no common SRTP profile")
            self.srtp_profile = SRTP_AES128_CM_SHA1_80
            self._client_random = ch["random"]
            self._server_random = os.urandom(32)
            self._transcript += raw
            # flight: ServerHello, Certificate, ServerKeyExchange,
            # CertificateRequest, ServerHelloDone
            sh = (struct.pack(">H", DTLS12) + self._server_random
                  + b"\x00"
                  + struct.pack(">H",
                                SUITE_ECDHE_ECDSA_AES128_GCM_SHA256)
                  + b"\x00" + self._extensions())
            self._send_handshake(HT_SERVER_HELLO, sh)
            self._send_handshake(HT_CERTIFICATE, _cert_body(self.cert))
            self._ecdh_priv = ec.generate_private_key(ec.SECP256R1())
            point = _raw_point(self._ecdh_priv.public_key())
            params = (b"\x03" + struct.pack(">H", GROUP_P256)
                      + bytes([len(point)]) + point)
            signed = (self._client_random + self._server_random
                      + params)
            sig = self.key.sign(signed, ec.ECDSA(hashes.SHA256()))
            ske = (params
                   + struct.pack(">H", SIGALG_ECDSA_P256_SHA256)
                   + struct.pack(">H", len(sig)) + sig)
            self._send_handshake(HT_SERVER_KEY_EXCHANGE, ske)
            cr = (b"\x01\x40"      # cert types: ecdsa_sign(64)
                  + struct.pack(">HH", 2, SIGALG_ECDSA_P256_SHA256)
                  + b"\x00\x00")   # no CAs
            self._send_handshake(HT_CERTIFICATE_REQUEST, cr)
            self._send_handshake(HT_SERVER_HELLO_DONE, b"")
            self._state = "wait_client_flight"
        elif ht == HT_CERTIFICATE:
            self._transcript += raw
            self.peer_cert = _parse_cert_body(body)
            _check_fingerprint(self.peer_cert,
                               self.remote_fingerprint)
        elif ht == HT_CLIENT_KEY_EXCHANGE:
            self._transcript += raw
            point = body[1:1 + body[0]]
            self._derive_master(point)
        elif ht == HT_CERTIFICATE_VERIFY:
            if self.peer_cert is None:
                raise DtlsError("CertificateVerify without Certificate")
            sigalg, = struct.unpack_from(">H", body)
            siglen, = struct.unpack_from(">H", body, 2)
            sig = body[4:4 + siglen]
            # signature covers the transcript up to (excl.) this msg
            from cryptography.exceptions import InvalidSignature
            try:
                self.peer_cert.public_key().verify(
                    sig, self._transcript, ec.ECDSA(hashes.SHA256()))
            except InvalidSignature as e:
                raise DtlsError("bad CertificateVerify signature")                     from e
            self._peer_cert_verified = True
            self._transcript += raw
        elif ht == HT_FINISHED:
            # we always send CertificateRequest: the client MUST have
            # authenticated, otherwise fingerprint pinning is moot
            if self.peer_cert is None \
                    or not getattr(self, "_peer_cert_verified", False):
                raise DtlsError("client Finished without verified "
                                "certificate")
            self._verify_finished(body, b"client finished", raw)
            # server CCS + Finished
            self._send_record(CT_CCS, b"\x01")
            self._epoch = 1
            self._seq = 0
            self._setup_record_keys()
            verify = _prf(self._master, b"server finished",
                          hashlib.sha256(self._transcript).digest(),
                          12)
            self._send_handshake(HT_FINISHED, verify)
            self._finish()

    # ---- client side -----------------------------------------------------
    def _dispatch_client(self, ht: int, body: bytes,
                         raw: bytes) -> None:
        if ht == HT_HELLO_VERIFY:
            self._cookie = body[3:3 + body[2]]
            # retry with cookie; transcript restarts at this CH
            self._transcript = b""
            self._send_handshake(HT_CLIENT_HELLO, self._client_hello())
            self._state = "wait_sh"
        elif ht == HT_SERVER_HELLO:
            self._transcript += raw
            self._server_random = body[2:34]
            sid_len = body[34]
            off = 35 + sid_len
            suite, = struct.unpack_from(">H", body, off)
            if suite != SUITE_ECDHE_ECDSA_AES128_GCM_SHA256:
                raise DtlsError(f"unexpected suite {suite:#x}")
            profiles = _parse_use_srtp(body[off + 3:])
            if SRTP_AES128_CM_SHA1_80 not in profiles:
                raise DtlsError("server offered no common SRTP profile")
            self.srtp_profile = SRTP_AES128_CM_SHA1_80
        elif ht == HT_CERTIFICATE:
            self._transcript += raw
            self.peer_cert = _parse_cert_body(body)
            _check_fingerprint(self.peer_cert,
                               self.remote_fingerprint)
        elif ht == HT_SERVER_KEY_EXCHANGE:
            if body[0] != 3:
                raise DtlsError("expected named_curve")
            group, = struct.unpack_from(">H", body, 1)
            if group != GROUP_P256:
                raise DtlsError("expected P-256")
            plen = body[3]
            point = body[4:4 + plen]
            off = 4 + plen
            sigalg, = struct.unpack_from(">H", body, off)
            siglen, = struct.unpack_from(">H", body, off + 2)
            sig = body[off + 4:off + 4 + siglen]
            params = body[:4 + plen]
            self.peer_cert.public_key().verify(
                sig, self._client_random + self._server_random
                + params, ec.ECDSA(hashes.SHA256()))
            self._peer_point = point
            self._transcript += raw
        elif ht == HT_CERTIFICATE_REQUEST:
            self._transcript += raw
            self._cert_requested = True
        elif ht == HT_SERVER_HELLO_DONE:
            self._transcript += raw
            # client flight: [Certificate], ClientKeyExchange,
            # [CertificateVerify], CCS, Finished
            if getattr(self, "_cert_requested", False):
                self._send_handshake(HT_CERTIFICATE,
                                     _cert_body(self.cert))
            self._ecdh_priv = ec.generate_private_key(ec.SECP256R1())
            point = _raw_point(self._ecdh_priv.public_key())
            self._send_handshake(HT_CLIENT_KEY_EXCHANGE,
                                 bytes([len(point)]) + point)
            self._derive_master(self._peer_point)
            if getattr(self, "_cert_requested", False):
                sig = self.key.sign(self._transcript,
                                    ec.ECDSA(hashes.SHA256()))
                cv = (struct.pack(">H", SIGALG_ECDSA_P256_SHA256)
                      + struct.pack(">H", len(sig)) + sig)
                self._send_handshake(HT_CERTIFICATE_VERIFY, cv)
            self._send_record(CT_CCS, b"\x01")
            self._epoch = 1
            self._seq = 0
            self._setup_record_keys()
            verify = _prf(self._master, b"client finished",
                          hashlib.sha256(self._transcript).digest(),
                          12)
            self._send_handshake(HT_FINISHED, verify)
            self._state = "wait_server_finished"
        elif ht == HT_FINISHED:
            self._verify_finished(body, b"server finished", raw)
            self._finish()

    # -- crypto plumbing ------------------------------------------------------
    def _derive_master(self, peer_point: bytes) -> None:
        peer_pub = ec.EllipticCurvePublicKey.from_encoded_point(
            ec.SECP256R1(), peer_point)
        pre = self._ecdh_priv.exchange(ec.ECDH(), peer_pub)
        self._master = _prf(pre, b"master secret",
                            self._client_random + self._server_random,
                            48)
        # record keys must exist before the peer's encrypted Finished
        # arrives (right after its CCS)
        self._setup_record_keys()

    def _setup_record_keys(self) -> None:
        kb = _prf(self._master, b"key expansion",
                  self._server_random + self._client_random,
                  2 * 16 + 2 * 4)
        ckey, skey = kb[0:16], kb[16:32]
        civ, siv = kb[32:36], kb[36:40]
        if self.is_client:
            self._keys = (ckey, civ, skey, siv)
        else:
            self._keys = (skey, siv, ckey, civ)

    def _verify_finished(self, body: bytes, label: bytes,
                         raw: bytes) -> None:
        if not self._master:
            # no key exchange happened: a Finished here is forged
            raise DtlsError("Finished before key exchange")
        want = _prf(self._master, label,
                    hashlib.sha256(self._transcript).digest(), 12)
        if not hmac.compare_digest(body, want):
            raise DtlsError("Finished verify_data mismatch")
        self._transcript += raw

    def _finish(self) -> None:
        # RFC 5764 §4.2: exporter over the handshake
        material = _prf(self._master, b"EXTRACTOR-dtls_srtp",
                        self._client_random + self._server_random,
                        2 * (SRTP_KEY_LEN + SRTP_SALT_LEN))
        off = 0
        ck = material[off:off + SRTP_KEY_LEN]; off += SRTP_KEY_LEN
        sk = material[off:off + SRTP_KEY_LEN]; off += SRTP_KEY_LEN
        cs = material[off:off + SRTP_SALT_LEN]; off += SRTP_SALT_LEN
        ss = material[off:off + SRTP_SALT_LEN]
        self.srtp_keys = SrtpKeys(ck, sk, cs, ss)
        self.connected = True


# ---------------------------------------------------------------------------
# body parsing helpers
# ---------------------------------------------------------------------------

def _parse_client_hello(body: bytes) -> dict:
    random = body[2:34]
    sid_len = body[34]
    off = 35 + sid_len
    cookie_len = body[off]
    cookie = body[off + 1:off + 1 + cookie_len]
    off += 1 + cookie_len
    cs_len, = struct.unpack_from(">H", body, off)
    off += 2 + cs_len
    comp_len = body[off]
    off += 1 + comp_len
    profiles = _parse_use_srtp(body[off:])
    return {"random": random, "cookie": cookie,
            "srtp_profiles": profiles}


def _parse_use_srtp(ext_block: bytes) -> list[int]:
    """ext_block starts at the 2-byte extensions length."""
    if len(ext_block) < 2:
        return []
    total, = struct.unpack_from(">H", ext_block)
    pos = 2
    end = min(2 + total, len(ext_block))
    while pos + 4 <= end:
        et, ln = struct.unpack_from(">HH", ext_block, pos)
        val = ext_block[pos + 4:pos + 4 + ln]
        if et == EXT_USE_SRTP and len(val) >= 2:
            plen, = struct.unpack_from(">H", val)
            return [struct.unpack_from(">H", val, 2 + i)[0]
                    for i in range(0, plen, 2)]
        pos += 4 + ln
    return []


def _cert_body(cert) -> bytes:
    der = cert.public_bytes(serialization.Encoding.DER)
    one = len(der).to_bytes(3, "big") + der
    return len(one).to_bytes(3, "big") + one


def _parse_cert_body(body: bytes):
    total = int.from_bytes(body[:3], "big")
    ln = int.from_bytes(body[3:6], "big")
    der = body[6:6 + ln]
    return x509.load_der_x509_certificate(der)


def _check_fingerprint(cert, expected: str | None) -> None:
    if expected is None:
        return
    got = fingerprint(cert)
    norm = lambda s: s.lower().replace(" ", "")
    if norm(got) != norm(expected):
        raise DtlsError(f"fingerprint mismatch: {got} != {expected}")
