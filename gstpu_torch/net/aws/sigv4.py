"""AWS Signature Version 4 request signing, from the published
algorithm (canonical request -> string-to-sign -> derived signing
key -> signature). Verified against AWS's documented example vector
in tests/test_aws.py.

The port's copy of gstpu/net/aws/sigv4.py, as it stands.
"""

from __future__ import annotations

import hashlib
import hmac
import urllib.parse
from datetime import datetime, timezone

EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()
UNSIGNED_PAYLOAD = "UNSIGNED-PAYLOAD"


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def signing_key(secret_key: str, date: str, region: str,
                service: str) -> bytes:
    k = _hmac(b"AWS4" + secret_key.encode(), date)
    k = _hmac(k, region)
    k = _hmac(k, service)
    return _hmac(k, "aws4_request")


def _uri_encode(s: str, encode_slash: bool) -> str:
    safe = "-_.~" + ("" if encode_slash else "/")
    return urllib.parse.quote(s, safe=safe)


def canonical_request(method: str, path: str, query: str,
                      headers: dict[str, str],
                      payload_hash: str) -> tuple[str, str]:
    """-> (canonical_request, signed_headers)."""
    # canonical query string: sorted by key then value, URI-encoded
    pairs = urllib.parse.parse_qsl(query, keep_blank_values=True)
    cq = "&".join(
        f"{_uri_encode(k, True)}={_uri_encode(v, True)}"
        for k, v in sorted(pairs))
    norm = {k.lower().strip(): " ".join(v.split())
            for k, v in headers.items()}
    signed = ";".join(sorted(norm))
    ch = "".join(f"{k}:{norm[k]}\n" for k in sorted(norm))
    cr = "\n".join([method, _uri_encode(path, False) or "/", cq, ch,
                    signed, payload_hash])
    return cr, signed


def sign_request(*, method: str, url: str, region: str,
                 service: str, access_key: str, secret_key: str,
                 headers: dict[str, str] | None = None,
                 payload: bytes | None = b"",
                 session_token: str | None = None,
                 now: datetime | None = None,
                 content_sha256_header: bool = True) \
        -> dict[str, str]:
    """Return the headers to send (incl. Authorization).
    `content_sha256_header` adds x-amz-content-sha256 (S3 requires
    it; other services sign without it — the AWS documented IAM
    vector in tests omits it)."""
    u = urllib.parse.urlsplit(url)
    now = now or datetime.now(timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    date = amz_date[:8]
    payload_hash = (hashlib.sha256(payload).hexdigest()
                    if payload is not None else UNSIGNED_PAYLOAD)
    hdrs = {"host": u.netloc, "x-amz-date": amz_date}
    if content_sha256_header:
        hdrs["x-amz-content-sha256"] = payload_hash
    if session_token:
        hdrs["x-amz-security-token"] = session_token
    if headers:
        hdrs.update({k.lower(): v for k, v in headers.items()})
    cr, signed = canonical_request(method, u.path, u.query, hdrs,
                                   payload_hash)
    scope = f"{date}/{region}/{service}/aws4_request"
    sts = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                     hashlib.sha256(cr.encode()).hexdigest()])
    key = signing_key(secret_key, date, region, service)
    sig = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
    hdrs["authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={signed}, Signature={sig}")
    return hdrs


def presign_url(*, method: str, url: str, region: str, service: str,
                access_key: str, secret_key: str,
                session_token: str | None = None,
                expires: int = 300,
                now: datetime | None = None) -> str:
    """SigV4 query-string presigning (the Transcribe streaming
    WebSocket endpoint authenticates this way)."""
    u = urllib.parse.urlsplit(url)
    now = now or datetime.now(timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    date = amz_date[:8]
    scope = f"{date}/{region}/{service}/aws4_request"
    params = list(urllib.parse.parse_qsl(u.query,
                                         keep_blank_values=True))
    params += [
        ("X-Amz-Algorithm", "AWS4-HMAC-SHA256"),
        ("X-Amz-Credential", f"{access_key}/{scope}"),
        ("X-Amz-Date", amz_date),
        ("X-Amz-Expires", str(expires)),
        ("X-Amz-SignedHeaders", "host"),
    ]
    if session_token:
        params.append(("X-Amz-Security-Token", session_token))
    query = "&".join(
        f"{_uri_encode(k, True)}={_uri_encode(v, True)}"
        for k, v in sorted(params))
    cr = "\n".join([method, _uri_encode(u.path, False) or "/", query,
                    f"host:{u.netloc}\n", "host", UNSIGNED_PAYLOAD])
    sts = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                     hashlib.sha256(cr.encode()).hexdigest()])
    key = signing_key(secret_key, date, region, service)
    sig = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
    return (f"{u.scheme}://{u.netloc}{u.path}?{query}"
            f"&X-Amz-Signature={sig}")
