"""The squeeze-excitation kernel's share of its roofline, in %: the least
time of every call in the traced sub-window (x read once and written
once; ``roofline.se_call``) over the device time of its kernels."""

import re

from bench_gpu.metrics_common import kernel_roofline

KERNELS = re.compile(r"\bse_fused\b")  # one cooperative launch per call
CALLS = KERNELS  # one launch per call


def read(rec):
    return kernel_roofline(rec, "se", KERNELS, CALLS)
