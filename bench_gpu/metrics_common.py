"""Arithmetic the per-layer readers share. Each returns None where the run
holds nothing to read (no trace, no such kernel, no work done)."""

from __future__ import annotations

from bench_gpu import roofline
from bench_gpu.trace import matching


def idle_share(rec):
    t = rec.get("trace")
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu(rec, images):
    if not images or not rec.get("flops_per_image"):
        return None
    rate = images * rec["flops_per_image"] / rec["window_s"]
    return 100.0 * rate / roofline.PEAK_FLOPS[rec["dtype"]]


def kernel_roofline(rec, kind: str, kernels, calls, count: str = None):
    """The summed least time of the traced calls at the sites of ``kind``
    over the device time of the kernels matching ``kernels``; ``calls``
    matches one launch per call. A call's least time is the mean over one
    forward's sites (``rec["sites"][kind]``), counted by
    ``roofline.CALLS[count or kind]``."""
    t = rec.get("trace")
    sites = (rec.get("sites") or {}).get(kind)
    if not t or not sites:
        return None
    secs, _ = matching(t, kernels)
    _, n = matching(t, calls)
    if secs <= 0 or n == 0:
        return None
    per_call = roofline.sites_bound(rec["sites"], kind, rec["dtype"],
                                    count) / len(sites)
    return 100.0 * n * per_call / secs
