"""Seconds of media completed per second of wall time, summed over every
stream: every buffer pushed in the window whose output was complete on
the device before it closed, over the window's length."""


def read(rec):
    n = len(rec.completed())
    return n * rec.media_s / (rec.window[1] - rec.window[0])
