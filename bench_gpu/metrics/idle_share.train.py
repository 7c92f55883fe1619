"""The device's idle share of the traced sub-window of a training cell,
in % (``bench_gpu/trace.py``)."""

from bench_gpu.metrics_common import idle_share


def read(rec):
    return idle_share(rec)
