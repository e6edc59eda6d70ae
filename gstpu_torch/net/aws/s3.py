"""S3 REST client: the object-storage subset the reference's
awss3src/awss3sink/awss3putobjectsink use from the AWS SDK
(net/aws/src/s3utils.rs, s3src/imp.rs, s3sink/) — HEAD/ranged GET,
PUT, and multipart upload (create/part/complete/abort) — over
urllib with SigV4 signing (gstpu/net/aws/sigv4.py).

URI format matches the reference's s3url.rs:
    s3://region/bucket/key[?version=V]
`endpoint-uri` overrides the host (S3-compatible stores, mock
servers); path-style addressing is used then, virtual-hosted
otherwise.

The port's copy of gstpu/net/aws/s3.py, as it stands.
"""

from __future__ import annotations

import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass

from gstpu_torch.net.aws.sigv4 import sign_request


class S3Error(RuntimeError):
    def __init__(self, status: int, message: str):
        super().__init__(f"S3 error {status}: {message}")
        self.status = status


@dataclass
class S3Url:
    region: str
    bucket: str
    key: str
    version: str | None = None

    @staticmethod
    def parse(uri: str) -> "S3Url":
        u = urllib.parse.urlsplit(uri)
        if u.scheme != "s3":
            raise ValueError(f"unsupported URI scheme '{u.scheme}'")
        region = u.netloc
        parts = u.path.lstrip("/").split("/", 1)
        if len(parts) != 2 or not parts[0] or not parts[1]:
            raise ValueError(f"invalid s3 uri '{uri}': need "
                             "s3://region/bucket/key")
        q = dict(urllib.parse.parse_qsl(u.query))
        return S3Url(region, parts[0], parts[1], q.get("version"))


class S3Client:
    def __init__(self, *, region: str, access_key: str,
                 secret_key: str, session_token: str | None = None,
                 endpoint_uri: str | None = None,
                 force_path_style: bool = False,
                 timeout: float = 15.0):
        self.region = region
        self.access_key = access_key
        self.secret_key = secret_key
        self.session_token = session_token
        self.endpoint_uri = endpoint_uri.rstrip("/") \
            if endpoint_uri else None
        self.force_path_style = force_path_style or bool(endpoint_uri)
        self.timeout = timeout

    # -- plumbing ---------------------------------------------------------
    def _object_url(self, bucket: str, key: str,
                    query: str = "") -> str:
        ekey = urllib.parse.quote(key, safe="/-_.~")
        if self.endpoint_uri:
            base = f"{self.endpoint_uri}/{bucket}/{ekey}"
        elif self.force_path_style:
            base = (f"https://s3.{self.region}.amazonaws.com/"
                    f"{bucket}/{ekey}")
        else:
            base = (f"https://{bucket}.s3.{self.region}"
                    f".amazonaws.com/{ekey}")
        return base + (f"?{query}" if query else "")

    def _request(self, method: str, url: str,
                 payload: bytes | None = b"",
                 headers: dict[str, str] | None = None):
        hdrs = sign_request(
            method=method, url=url, region=self.region, service="s3",
            access_key=self.access_key, secret_key=self.secret_key,
            session_token=self.session_token, headers=headers,
            payload=payload)
        req = urllib.request.Request(
            url, data=payload if method in ("PUT", "POST") else None,
            method=method, headers=hdrs)
        try:
            return urllib.request.urlopen(req, timeout=self.timeout)
        except urllib.error.HTTPError as e:
            body = e.read().decode(errors="replace")[:300]
            raise S3Error(e.code, body or e.reason) from e

    # -- object operations ------------------------------------------------
    def head_object(self, bucket: str, key: str) -> int:
        """-> content length."""
        with self._request("HEAD",
                           self._object_url(bucket, key)) as r:
            return int(r.headers.get("Content-Length", 0))

    def get_object(self, bucket: str, key: str,
                   start: int | None = None,
                   end: int | None = None) -> bytes:
        """Ranged GET; `end` inclusive (HTTP Range semantics)."""
        headers = {}
        if start is not None:
            headers["range"] = (f"bytes={start}-"
                                + ("" if end is None else str(end)))
        with self._request("GET", self._object_url(bucket, key),
                           headers=headers or None) as r:
            return r.read()

    def put_object(self, bucket: str, key: str, data: bytes,
                   content_type: str | None = None) -> str:
        headers = {}
        if content_type:
            headers["content-type"] = content_type
        with self._request("PUT", self._object_url(bucket, key),
                           payload=data,
                           headers=headers or None) as r:
            return r.headers.get("ETag", "")

    # -- multipart upload (reference multipartsink.rs flow) ---------------
    def create_multipart(self, bucket: str, key: str) -> str:
        with self._request("POST", self._object_url(bucket, key,
                                                    "uploads")) as r:
            body = r.read().decode()
        uid = _xml_field(body, "UploadId")
        if not uid:
            raise S3Error(500, "no UploadId in response")
        return uid

    def upload_part(self, bucket: str, key: str, upload_id: str,
                    part_number: int, data: bytes) -> str:
        q = f"partNumber={part_number}&uploadId={upload_id}"
        with self._request("PUT", self._object_url(bucket, key, q),
                           payload=data) as r:
            return r.headers.get("ETag", "")

    def complete_multipart(self, bucket: str, key: str,
                           upload_id: str,
                           parts: list[tuple[int, str]]) -> None:
        body = "<CompleteMultipartUpload>" + "".join(
            f"<Part><PartNumber>{n}</PartNumber>"
            f"<ETag>{etag}</ETag></Part>" for n, etag in parts) \
            + "</CompleteMultipartUpload>"
        q = f"uploadId={upload_id}"
        self._request("POST", self._object_url(bucket, key, q),
                      payload=body.encode()).close()

    def abort_multipart(self, bucket: str, key: str,
                        upload_id: str) -> None:
        q = f"uploadId={upload_id}"
        self._request("DELETE",
                      self._object_url(bucket, key, q)).close()


def _xml_field(xml: str, tag: str) -> str | None:
    open_t, close_t = f"<{tag}>", f"</{tag}>"
    i = xml.find(open_t)
    if i < 0:
        return None
    j = xml.find(close_t, i)
    return xml[i + len(open_t):j] if j > i else None
