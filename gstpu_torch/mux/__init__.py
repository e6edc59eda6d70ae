"""Muxers/demuxers of the port: copies of gstpu/mux/ (ISO BMFF boxes, FLV)."""
