"""RTP/RTCP stack (reference net/rtp rtpbin2): sans-IO session +
jitterbuffer state machines, packet codecs, payloader bases."""
