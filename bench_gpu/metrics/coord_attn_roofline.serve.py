"""The coordinate-attention kernels' share of their roofline, in %: the
least time of every call in the traced sub-window (x read once and
written once; ``roofline.coord_attn_call``) over the device time of the
call's kernels (pool, bottleneck, apply, and the fold where a plan has
one)."""

import re

from bench_gpu.metrics_common import kernel_roofline

KERNELS = re.compile(r"\bca_(?:pool|bottleneck|apply|fold)\b")
CALLS = re.compile(r"\bca_apply\b")  # one per call


def read(rec):
    return kernel_roofline(rec, "coord_attn", KERNELS, CALLS)
