"""The flash-attention backward kernels' share of their roofline, in %:
the least time of every backward call in the traced sub-window (the
inputs and gradients moved once, four products counted and the S computed
again not; ``roofline.flash_bwd_call``) over the device time of the dQ and
dK/dV kernels."""

import re

from bench_gpu.metrics_common import kernel_roofline

KERNELS = re.compile(r"\bflash_bwd_(?:dq|dkv)\b")
CALLS = re.compile(r"\bflash_bwd_dq\b")  # one per call


def read(rec):
    return kernel_roofline(rec, "flash", KERNELS, CALLS, "flash_bwd")
