"""Device ms per step of the optimizer's operations: those launched inside
the program's ``train.optimizer`` spans (the clip and the update) that lie
wholly in the traced sub-window, per such span."""

from bench_gpu.spans import whole_device_ms


def read(rec):
    return whole_device_ms(rec, "train.optimizer")
