"""The 95th percentile, over every buffer completed in the window, of
the time from its push to its output being complete on the device."""

import numpy as np


def read(rec):
    lat = rec.completed()
    if lat.size == 0:
        return None
    return float(np.percentile(lat, 95)) * 1e3
