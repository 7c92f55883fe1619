"""The yardstick's counts against hand counts at tiny shapes."""

import re

import pytest
import torch
import torch.nn as nn

from bench_gpu import roofline
from bench_gpu.families import context_unet as fam
from bench_gpu.metrics_common import idle_share, kernel_roofline, mfu
from bench_gpu.trace import reduce_events

TINY = {"model": {"in_ch": 3, "n_feat": 16, "n_classes": 5, "img_size": 32,
                  "attn_reduction": 16},
        "diffusion": {"high_thresh": 1.2}}


def test_model_flops_counts_convolutions_and_products():
    conv = nn.Conv2d(4, 6, 3, padding=1, device="meta")
    lin = nn.Linear(10, 7, device="meta")
    x = torch.zeros(2, 4, 5, 5, device="meta")
    y = torch.zeros(3, 10, device="meta")
    got = roofline.model_flops(lambda: (conv(x), lin(y)))
    assert got == 2 * (2 * 6 * 5 * 5 * 4 * 9) + 2 * (3 * 7 * 10)


def test_train_flops_are_forward_and_backward():
    fwd = fam.forward_flops(TINY, 1)
    train = fam.train_flops(TINY, 1)
    # the loss's spatial mask adds the LocalEnhancer's two convolutions
    # (16 -> 16 channels, 3x3, 32x32) to the forward
    enh = 2 * (2 * 16 * 32 * 32 * 16 * 9)
    # a backward takes twice a forward's products, less the input
    # gradients of the layers that read the inputs (images, t and the
    # class vector need none): the first 3x3 convolution and the four
    # embeddings' first dense layers (1 -> 128, 1 -> 64, 5 -> 128, 5 -> 64)
    first = 2 * 16 * 32 * 32 * 3 * 9 + 2 * (128 + 64 + 5 * 128 + 5 * 64)
    assert train == 3 * (fwd + enh) - first
    assert fam.forward_flops(TINY, 4) == 4 * fwd


def test_sites_follow_the_net():
    s = fam.sites(TINY, 4)
    assert s["se"] == [(4, 32, 32, 16, 1), (4, 32, 32, 16, 1),
                       (4, 16, 16, 32, 2), (4, 8, 8, 64, 4),
                       (4, 4, 4, 128, 8)]
    assert s["coord_attn"] == [(4, 16, 16, 16, 1), (4, 8, 8, 32, 2),
                               (4, 4, 4, 64, 4), (4, 2, 2, 128, 8)]


def test_kernel_bounds_by_hand():
    se = roofline.se_call(16, 256, 256, 192, 12, "bfloat16")
    n = 16 * 256 * 256 * 192
    assert se["bytes"] == 2 * n * 2 + 2 * 192 * 12 * 4
    assert se["bound_by"] == "bytes"
    assert se["seconds"] == pytest.approx(se["bytes"] / 3.35e12)
    ca = roofline.coord_attn_call(16, 128, 128, 192, 12, "bfloat16")
    assert ca["bytes"] == 2 * (16 * 128 * 128 * 192) * 2 + (
        2 * 192 * 12 + 2 * 144 + 2 * 12 * 192) * 4
    assert roofline.least_time(0, 989e12, "bfloat16") == (1.0, "operations")


def test_readers_on_a_synthetic_trace():
    ns = 1_000_000_000
    events = [("cudaLaunchKernel", False, 0, ns // 100),
              ("void se_fused<bf16>(x)", True, 0, ns // 10),
              ("void se_fused<bf16>(x)", True, ns // 5, 3 * ns // 10),
              ("void ca_pool<bf16>(x)", True, ns // 2, 6 * ns // 10),
              ("void ca_apply<bf16>(x)", True, 55 * ns // 100, 7 * ns // 10),
              ("cudaStreamSynchronize", False, 7 * ns // 10, 8 * ns // 10),
              ("cudaDeviceSynchronize", False, 8 * ns // 10, ns)]
    red = reduce_events(events)
    assert red["window_s"] == pytest.approx(1.0)
    assert red["busy_s"] == pytest.approx(0.1 + 0.1 + 0.2)
    assert red["idle_gaps"][0][1] == pytest.approx(0.3)
    assert red["idle_gaps"][0][0] == "cudaDeviceSynchronize"
    rec = {"trace": red, "dtype": "bfloat16",
           "sites": {"se": [(1, 8, 8, 8, 1)] * 2,
                     "coord_attn": [(1, 8, 8, 8, 1)]}}
    assert idle_share(rec) == pytest.approx(60.0)
    se = kernel_roofline(rec, "se", re.compile(r"\bse_fused\b"),
                         re.compile(r"\bse_fused\b"))
    want = 2 * roofline.se_call(1, 8, 8, 8, 1, "bfloat16")["seconds"] / 0.2
    assert se == pytest.approx(100 * want)
    assert kernel_roofline(rec, "se", re.compile("nothing"),
                           re.compile("nothing")) is None
    assert mfu({"window_s": 2.0, "flops_per_image": 989e12,
                "dtype": "bfloat16"}, 1) == pytest.approx(50.0)
    assert mfu({"window_s": 2.0, "flops_per_image": 1.0,
                "dtype": "bfloat16"}, 0) is None


def test_sub_window_edges_come_from_the_trace():
    """The sub-window opens with the first runtime call and closes at the
    end of the last device synchronisation: a kernel queued before the
    opening counts from it, one that ends after the close up to it, and
    device work outside counts nothing."""
    ns = 1_000_000_000
    sync = ("cudaDeviceSynchronize", False, 8 * ns // 10, ns)
    early = reduce_events([("cudaLaunchKernel", False, 0, ns // 100),
                           ("k", True, -ns // 10, ns // 10), sync])
    assert early["busy_s"] == pytest.approx(0.1)
    late = reduce_events([("cudaLaunchKernel", False, 0, ns // 100),
                          ("k", True, 9 * ns // 10, 2 * ns), sync])
    assert late["busy_s"] == pytest.approx(0.1)
    outside = reduce_events([("cudaLaunchKernel", False, ns // 2, ns),
                             ("k", True, 0, ns // 4), sync])
    assert outside["busy_s"] == 0 and outside["window_s"] == 0.5
    with pytest.raises(ValueError):
        reduce_events([("k", True, 0, ns), ("cudaLaunchKernel", False, 0, 1)])
