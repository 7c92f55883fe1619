"""The 90th percentile of every request's wait in the service's queue over
the window, from its submission to the start of the run of the batch that
carried it (the program's ``serve.queue`` spans; numpy's linear
percentile, as ``request_p90_s``)."""

import numpy as np

from bench_gpu.spans import program


def read(rec):
    p = program(rec)
    waits = p and p["durations"].get("serve.queue")
    if not waits:
        return None
    return float(np.percentile(np.asarray(waits, np.float64), 90))
