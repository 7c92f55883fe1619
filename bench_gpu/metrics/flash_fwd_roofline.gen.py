"""The flash-attention forward kernel's share of its roofline, in %: the
least time of every call in the traced sub-window (q, k, v read once, o
written once, QK^T and PV counted once; ``roofline.flash_fwd_call`` at the
configuration's precision) over the device time of its kernel."""

import re

from bench_gpu.metrics_common import kernel_roofline

KERNELS = re.compile(r"\bflash_fwd\b")
CALLS = KERNELS  # one launch per call


def read(rec):
    return kernel_roofline(rec, "flash", KERNELS, CALLS)
