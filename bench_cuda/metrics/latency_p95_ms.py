"""latency_p95_ms: the 95th percentile (numpy's linear interpolation) of
the wall times of all the window's requests. Host clock."""

import numpy as np


def read(run):
    lat = [(r.end - r.start) * 1e3 for r in run.window]
    return float(np.percentile(lat, 95)) if lat else None
