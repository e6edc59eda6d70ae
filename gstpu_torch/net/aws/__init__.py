"""AWS protocol layer (reference net/aws crate, 13k LoC around the
AWS SDKs): gstpu implements the wire protocols directly — SigV4
request signing and the S3 REST surface the storage elements need —
so the elements are fully testable against in-process mock servers
in this zero-egress environment and work against real endpoints
(or S3-compatible stores) when credentials and network exist.

The port's copy of gstpu/net/aws/__init__.py, as it stands.
"""
