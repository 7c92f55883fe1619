"""The whole generation step's share of the card's peak, in %: the model
FLOPs of the images returned in the window (every denoiser call of their
sampler, guidance doubling the rows; counted on the plain reference's
shapes on the meta device) over the window, over the peak of the
configuration's precision (``bench_gpu/roofline.py``)."""

from bench_gpu.metrics_common import mfu


def read(rec):
    return mfu(rec, rec.get("images"))
