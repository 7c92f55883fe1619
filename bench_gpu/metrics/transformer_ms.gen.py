"""Device ms per SpatialTransformer call of the LDM UNet: the operations
launched inside the program's ``ldm.transformer`` spans that lie wholly
in the traced sub-window (norm, projections, every block's attention and
feed-forward), per such span; None when no span lies wholly in it or the
program records none."""

from bench_gpu.spans import whole_device_ms


def read(rec):
    return whole_device_ms(rec, "ldm.transformer")
