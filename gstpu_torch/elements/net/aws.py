"""AWS S3 elements: awss3src, awss3sink (multipart), awss3putobjectsink,
awss3hlssink.

Rebuilds the reference net/aws storage elements
(net/aws/src/{s3src/imp.rs,s3sink/multipartsink.rs,
s3sink/putobjectsink.rs,s3hlssink/}) over gstpu's own SigV4 + S3
REST client (gstpu/net/aws/) instead of the AWS SDK. URI format
matches s3url.rs: s3://region/bucket/key. `endpoint-uri` points the
elements at any S3-compatible store (tests run an in-process mock;
real AWS needs network + credentials — the env gate is the network,
not the protocol).

The port's copy of gstpu/elements/net/aws.py, as it stands.
"""

from __future__ import annotations

from gstpu_torch.core.base import BaseSink, PushSrc
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.element import (FlowError, FlowReturn, PadDirection,
                                      PadPresence, PadTemplate)
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element


class _S3Mixin:
    access_key = Property(str, default=None, mutable=Mutability.READY)
    secret_access_key = Property(str, default=None,
                                 mutable=Mutability.READY)
    session_token = Property(str, default=None,
                             mutable=Mutability.READY)
    endpoint_uri = Property(str, default=None,
                            mutable=Mutability.READY,
                            blurb="override the S3 endpoint "
                                  "(S3-compatible stores)")
    force_path_style = Property(bool, default=False,
                                mutable=Mutability.READY)
    request_timeout = Property(float, default=15.0, minimum=0.0)
    retry_attempts = Property(int, default=3, minimum=0, maximum=10)

    def _client(self, region: str):
        from gstpu_torch.net.aws.s3 import S3Client
        return S3Client(
            region=region, access_key=self.access_key or "",
            secret_key=self.secret_access_key or "",
            session_token=self.session_token,
            endpoint_uri=self.endpoint_uri,
            force_path_style=self.force_path_style,
            timeout=self.request_timeout)

    def _retrying(self, fn, *args, **kwargs):
        from gstpu_torch.net.aws.s3 import S3Error
        last = None
        for _ in range(self.retry_attempts + 1):
            try:
                return fn(*args, **kwargs)
            except S3Error as e:
                last = e
                if e.status < 500:       # client errors don't retry
                    break
        raise last


@register_element("awss3src", Rank.NONE)
class AwsS3Src(_S3Mixin, PushSrc):
    """Reads an S3 object in ranged GETs; serves pull-mode getrange
    too (reference s3src/imp.rs)."""

    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC,
                                 PadPresence.ALWAYS, Caps.any())]

    uri = Property(str, default=None, mutable=Mutability.READY,
                   blurb="s3://region/bucket/key")
    blocksize = Property(int, default=262144, minimum=1)

    def __init__(self, name=None):
        super().__init__(name)
        self._s3 = None
        self._url = None
        self._size = 0
        self._offset = 0

    def start(self) -> bool:
        from gstpu_torch.net.aws.s3 import S3Error, S3Url
        if not self.uri:
            self.post_error("awss3src: no uri set")
            return False
        try:
            self._url = S3Url.parse(self.uri)
        except ValueError as e:
            self.post_error(f"awss3src: {e}")
            return False
        self._s3 = self._client(self._url.region)
        try:
            self._size = self._retrying(
                self._s3.head_object, self._url.bucket, self._url.key)
        except S3Error as e:
            self.post_error(f"awss3src: {e}")
            return False
        self._offset = 0
        self.srcpad.get_range_function = self._get_range
        return True

    @property
    def size(self) -> int:
        return self._size

    def _get_range(self, pad, offset: int, size: int) -> bytes:
        if offset >= self._size:
            return b""
        end = min(offset + size, self._size) - 1
        return self._retrying(self._s3.get_object, self._url.bucket,
                              self._url.key, offset, end)

    def negotiate(self) -> Caps:
        return Caps.new("application/octet-stream")

    def create(self) -> Buffer | None:
        if self._offset >= self._size:
            return None                  # EOS
        data = self._get_range(None, self._offset, self.blocksize)
        if not data:
            return None
        buf = Buffer(data, offset=self._offset,
                     offset_end=self._offset + len(data))
        self._offset += len(data)
        return buf


class _S3SinkBase(_S3Mixin, BaseSink):
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK,
                                 PadPresence.ALWAYS, Caps.any())]

    uri = Property(str, default=None, mutable=Mutability.READY)
    region = Property(str, default="us-west-2",
                      mutable=Mutability.READY)
    bucket = Property(str, default=None, mutable=Mutability.READY)
    key = Property(str, default=None, mutable=Mutability.READY)
    content_type = Property(str, default=None,
                            mutable=Mutability.READY)

    def _resolve_target(self) -> bool:
        from gstpu_torch.net.aws.s3 import S3Url
        if self.uri:
            try:
                u = S3Url.parse(self.uri)
            except ValueError as e:
                self.post_error(f"{self.ELEMENT_NAME}: {e}")
                return False
            self.region, self.bucket, self.key = \
                u.region, u.bucket, u.key
        if not self.bucket or not self.key:
            self.post_error(f"{self.ELEMENT_NAME}: bucket/key "
                            "(or uri) required")
            return False
        return True


@register_element("awss3sink", Rank.NONE)
class AwsS3Sink(_S3SinkBase):
    """Multipart upload sink (reference s3sink/multipartsink.rs):
    accumulates part-size bytes per UploadPart, completes the upload
    at EOS, aborts on error."""

    part_size = Property(int, default=5 * 1024 * 1024,
                         minimum=5 * 1024 * 1024,
                         maximum=5 * 1024 * 1024 * 1024,
                         mutable=Mutability.READY,
                         blurb="bytes per multipart part (S3 minimum "
                               "5 MiB applies to all but the last)")

    def __init__(self, name=None):
        super().__init__(name)
        self._s3 = None
        self._upload_id = None
        self._parts: list[tuple[int, str]] = []
        self._acc = bytearray()

    def start(self) -> bool:
        from gstpu_torch.net.aws.s3 import S3Error
        if not self._resolve_target():
            return False
        self._s3 = self._client(self.region)
        try:
            self._upload_id = self._retrying(
                self._s3.create_multipart, self.bucket, self.key)
        except S3Error as e:
            self.post_error(f"awss3sink: {e}")
            return False
        self._parts = []
        self._acc = bytearray()
        return True

    def _upload(self, data: bytes) -> None:
        if not data:
            return
        n = len(self._parts) + 1
        etag = self._retrying(self._s3.upload_part, self.bucket,
                              self.key, self._upload_id, n, data)
        self._parts.append((n, etag))

    def render(self, buf: Buffer):
        from gstpu_torch.net.aws.s3 import S3Error
        self._acc += buf.to_bytes()
        try:
            while len(self._acc) >= self.part_size:
                data = bytes(self._acc[:self.part_size])
                del self._acc[:self.part_size]
                self._upload(data)
        except S3Error as e:
            self.post_error(f"awss3sink: {e}")
            raise FlowError(FlowReturn.ERROR)
        return FlowReturn.OK

    def on_eos(self) -> None:
        from gstpu_torch.net.aws.s3 import S3Error
        try:
            self._upload(bytes(self._acc))
            self._acc = bytearray()
            if self._upload_id is not None:
                self._retrying(self._s3.complete_multipart,
                               self.bucket, self.key,
                               self._upload_id, self._parts)
                self._upload_id = None
        except S3Error as e:
            self.post_error(f"awss3sink: complete failed: {e}")

    def stop(self) -> bool:
        from gstpu_torch.net.aws.s3 import S3Error
        if self._upload_id is not None:   # error path: abort
            try:
                self._s3.abort_multipart(self.bucket, self.key,
                                         self._upload_id)
            except S3Error:
                pass
            self._upload_id = None
        return True


@register_element("awss3putobjectsink", Rank.NONE)
class AwsS3PutObjectSink(_S3SinkBase):
    """Whole-object PUT sink with periodic re-puts (reference
    s3sink/putobjectsink.rs): better for small/slow streams than
    multipart; flush-interval-{buffers,bytes,time} re-upload the
    accumulated object so readers see progress."""

    flush_interval_buffers = Property(int, default=0, minimum=0,
                                      blurb="re-PUT every N buffers "
                                            "(0 = only at EOS)")
    flush_interval_bytes = Property(int, default=0, minimum=0)
    flush_interval_time = Property(int, default=0, minimum=0,
                                   blurb="re-PUT every N ns of "
                                         "buffer PTS")
    flush_on_error = Property(bool, default=False)

    def __init__(self, name=None):
        super().__init__(name)
        self._s3 = None
        self._acc = bytearray()
        self._since_flush = [0, 0, None]  # buffers, bytes, last pts

    def start(self) -> bool:
        if not self._resolve_target():
            return False
        self._s3 = self._client(self.region)
        self._acc = bytearray()
        self._since_flush = [0, 0, None]
        return True

    def _put(self) -> None:
        self._retrying(self._s3.put_object, self.bucket, self.key,
                       bytes(self._acc), self.content_type)

    def _should_flush(self, buf: Buffer) -> bool:
        b, by, pts0 = self._since_flush
        if self.flush_interval_buffers and \
                b >= self.flush_interval_buffers:
            return True
        if self.flush_interval_bytes and \
                by >= self.flush_interval_bytes:
            return True
        if self.flush_interval_time and buf.pts is not None \
                and pts0 is not None \
                and buf.pts - pts0 >= self.flush_interval_time:
            return True
        return False

    def render(self, buf: Buffer):
        from gstpu_torch.net.aws.s3 import S3Error
        self._acc += buf.to_bytes()
        st = self._since_flush
        st[0] += 1
        st[1] += len(buf.to_bytes())
        if st[2] is None and buf.pts is not None:
            st[2] = buf.pts
        if self._should_flush(buf):
            try:
                self._put()
            except S3Error as e:
                self.post_error(f"awss3putobjectsink: {e}")
                raise FlowError(FlowReturn.ERROR)
            self._since_flush = [0, 0, buf.pts]
        return FlowReturn.OK

    def on_eos(self) -> None:
        from gstpu_torch.net.aws.s3 import S3Error
        try:
            self._put()
        except S3Error as e:
            self.post_error(f"awss3putobjectsink: final PUT "
                            f"failed: {e}")


@register_element("awss3hlssink", Rank.NONE)
class AwsS3HlsSink(_S3Mixin, __import__(
        "gstpu_torch.elements.net.hls", fromlist=["HlsCmafSink"]
).HlsCmafSink):
    """HLS segmenter writing segments + playlists straight to S3
    (reference net/aws/src/s3hlssink/): the CMAF segmenter's storage
    hooks upload to s3://region/bucket/<prefix>/<name> instead of
    the local filesystem."""

    uri = Property(str, default=None, mutable=Mutability.READY,
                   blurb="s3://region/bucket/prefix — segments and "
                         "playlist land under this prefix")

    def __init__(self, name=None):
        super().__init__(name)
        self._s3 = None
        self._bucket = None
        self._prefix = ""

    def start(self) -> bool:
        from gstpu_torch.net.aws.s3 import S3Url
        if not self.uri:
            self.post_error("awss3hlssink: no uri set")
            return False
        try:
            u = S3Url.parse(self.uri)
        except ValueError as e:
            self.post_error(f"awss3hlssink: {e}")
            return False
        self._s3 = self._client(u.region)
        self._bucket, self._prefix = u.bucket, u.key.rstrip("/")
        return True

    def _key(self, path: str) -> str:
        import os as _os
        return f"{self._prefix}/{_os.path.basename(path)}"

    def _store(self, path: str, data: bytes) -> None:
        from gstpu_torch.net.aws.s3 import S3Error
        try:
            self._retrying(self._s3.put_object, self._bucket,
                           self._key(path), data)
        except S3Error as e:
            self.post_error(f"awss3hlssink: {e}")
            raise FlowError(FlowReturn.ERROR)

    def _delete(self, path: str) -> None:
        pass          # window-expired segments stay in S3 (lifecycle
                      # rules handle retention, like the reference)
