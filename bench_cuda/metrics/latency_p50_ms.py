"""latency_p50_ms: the median wall time of the window's requests, from the
call with the input to the answer back on the host. Host clock."""

import numpy as np


def read(run):
    lat = [(r.end - r.start) * 1e3 for r in run.window]
    return float(np.percentile(lat, 50)) if lat else None
