"""The 90th percentile of the latency of every request of the window, from
its submission to its result (host clock; numpy's linear percentile)."""

import numpy as np


def read(rec):
    lat = rec.get("latencies")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat, np.float64), 90))
