"""The device's idle share of the traced sub-window of a generation cell,
in %: the time in which no operation ran on the card over the
sub-window's length (``bench_gpu/trace.py``)."""

from bench_gpu.metrics_common import idle_share


def read(rec):
    return idle_share(rec)
