"""Host codecs of the port: copies of gstpu's pure NumPy codecs that the
ported elements need (the FFV1 spec model; FLAC, Ogg, Vorbis and MPEG-TS
for the file edge)."""
