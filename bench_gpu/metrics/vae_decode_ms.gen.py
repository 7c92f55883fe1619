"""Device ms per image of the VAE decode: the operations launched inside
the program's ``ldm.decode`` spans that lie wholly in the traced
sub-window, over the images those decodes returned; None when no decode
lies wholly in it."""

from bench_gpu.spans import whole_device_ms


def read(rec):
    return whole_device_ms(rec, "ldm.decode", "images")
