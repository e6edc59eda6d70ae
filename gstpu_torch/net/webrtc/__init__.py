"""WebRTC signalling layer (reference net/webrtc protocol +
signalling server).

The port's copy of gstpu/net/webrtc/__init__.py, as it stands.
"""
