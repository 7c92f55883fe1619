"""The whole training step's share of the card's peak, in %: the model FLOPs
(forward and backward, no recomputation counted) of the images the
window's steps consumed, over the window, over the peak of the
configuration's precision."""

from bench_gpu.metrics_common import mfu


def read(rec):
    return mfu(rec, rec.get("trained_images"))
