"""The GroupNorm + activation kernel on the card, held to its plain twin.

Marked ``cuda``: every test here skips where CUDA is absent (the CPU
tier). On a machine with a card, where JAX is not installed, run them
without the repository's conftest (it imports jax):

    python -m pytest --noconftest tests/test_torch_group_norm_cuda.py -q

Tolerance, set from the dtype: the kernel and the twin (``F.group_norm``
on the float32 values, then the bf16 program) compute the affine and the
activation alike and sum the statistics in other orders, so the
normalised bf16 output (act None) lies within one bf16 ulp of the twin's
where a rounding boundary falls between the two sums. Where the
normalised value is near 0 (|y| under 2**-8 of the statistics' rounding,
~1e-7 here) one ulp is smaller than that rounding, so a difference up to
2**-16 is taken there too. The activation is then held bit for bit to
the twin's bf16 activation applied to the kernel's own normalised output,
and every output is identical to the twin's on at least 99% of elements.
"""

import pytest
import torch

from diffusionmodel_tpu_torch import tracing
from diffusionmodel_tpu_torch.kernels.group_norm import (
    activation,
    group_norm_act,
    group_norm_act_plain,
)
from diffusionmodel_tpu_torch.nn.blocks import GroupNorm

pytestmark = pytest.mark.cuda

ATOL_NEAR_ZERO = 2.0 ** -16
SAME_SHARE = 0.99
# The flagship's GroupNorm sites (n_feat 192, 256 px; 8 groups each) as
# (H, C), at the serving cell's batch of 16 rows.
SITES = [(256, 192), (256, 48), (128, 48), (128, 384), (64, 96), (64, 768),
         (32, 192), (32, 1536), (16, 1536), (32, 768), (64, 384), (128, 192)]
BATCH = 16
# ragged: C / 8 groups of 5 channels (a vector across two groups), one
# channel a group, one group, a part shorter than the lanes, one pixel
RAGGED = [((3, 7, 9, 40), 8), ((2, 5, 5, 8), 8), ((2, 33, 31, 64), 1),
          ((5, 3, 3, 1536), 8), ((1, 1, 2, 4096), 32)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(shape, dev, seed=0):
    """bf16 x with a mean and a scale per channel, and a random affine."""
    b, h, w, c = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    scale = 0.5 + 1.5 * torch.rand(c, generator=g, device=dev)
    shift = 2 * torch.rand(c, generator=g, device=dev) - 1
    x = torch.randn(shape, generator=g, device=dev) * scale + shift
    weight = 1 + 0.2 * torch.randn(c, generator=g, device=dev)
    bias = 0.2 * torch.randn(c, generator=g, device=dev)
    return x.bfloat16(), weight, bias


def _ordered(t):
    """bf16 bit patterns as integers in the order of their values."""
    bits = t.contiguous().view(torch.int16).int()
    mag = bits & 0x7FFF
    return torch.where(bits < 0, -mag, mag)


def _within_one_ulp(got, want):
    ulps = (_ordered(got) - _ordered(want)).abs()
    near = (got.float() - want.float()).abs() <= ATOL_NEAR_ZERO
    bad = ~((ulps <= 1) | near)
    assert not bad.any(), (int(bad.sum()), int(ulps.max()),
                           got[bad][:8].tolist(), want[bad][:8].tolist())


def _same_share(got, want) -> float:
    return (got == want).float().mean().item()


@pytest.mark.parametrize("hc", SITES, ids=[f"{h}px_{c}" for h, c in SITES])
def test_kernel_matches_twin_at_flagship_sites(dev, hc):
    h, c = hc
    x, w, b = _inputs((BATCH, h, h, c), dev, seed=h + c)
    with torch.no_grad():
        n = group_norm_act.launches
        y = group_norm_act(x, w, b, 8)
        torch.cuda.synchronize()
        assert group_norm_act.launches == n + 1
        want = group_norm_act_plain(x, w, b, 8)
        _within_one_ulp(y, want)
        assert _same_share(y, want) >= SAME_SHARE
        for act in ("gelu", "relu"):
            got = group_norm_act(x, w, b, 8, 1e-5, act)
            assert torch.equal(got, activation(y, act)), act
            assert _same_share(got, group_norm_act_plain(
                x, w, b, 8, 1e-5, act)) >= SAME_SHARE, act
            # fixed summation order: bit-identical reruns
            assert torch.equal(group_norm_act(x, w, b, 8, 1e-5, act), got)


@pytest.mark.parametrize("case", RAGGED, ids=[str(s) for s, _ in RAGGED])
def test_kernel_matches_twin_on_ragged_shapes(dev, case):
    shape, groups = case
    x, w, b = _inputs(shape, dev, seed=7)
    with torch.no_grad():
        y = group_norm_act(x, w, b, groups, 1e-6)
        _within_one_ulp(y, group_norm_act_plain(x, w, b, groups, 1e-6))
        got = group_norm_act(x, w, b, groups, 1e-6, "gelu")
        assert torch.equal(got, activation(y, "gelu"))


@pytest.mark.parametrize("hc", [(256, 192), (64, 96), (16, 1536)])
def test_sample_alone_and_at_every_batch_position(dev, hc):
    """A sample's bits do not depend on its batch neighbours or its slot
    (``SamplerService``'s seed-pinned requests rely on it)."""
    h, c = hc
    x, w, b = _inputs((BATCH, h, h, c), dev, seed=3)
    with torch.no_grad():
        alone = group_norm_act(x[5:6].contiguous(), w, b, 8, 1e-5, "gelu")
        for pos in range(BATCH):
            xb = x.clone()
            xb[pos] = x[5]
            got = group_norm_act(xb, w, b, 8, 1e-5, "gelu")
            assert torch.equal(got[pos:pos + 1], alone), pos


def test_calls_of_other_shapes_in_turn(dev):
    """Calls of other shapes, batch sizes and activations on one stream
    share the published words; each call reads only its own epoch's."""
    cases = [((4, 32, 32, 384), "gelu"), ((16, 16, 16, 1536), "relu"),
             ((2, 64, 64, 96), None), ((16, 128, 128, 48), "gelu")]
    with torch.no_grad():
        inputs = [_inputs(s, dev, seed=i) for i, (s, _) in enumerate(cases)]
        first = [group_norm_act(x, w, b, 8, 1e-5, act)
                 for (x, w, b), (_, act) in zip(inputs, cases)]
        for _ in range(3):
            for (x, w, b), (_, act), want in zip(inputs, cases, first):
                assert torch.equal(group_norm_act(x, w, b, 8, 1e-5, act),
                                   want)


def test_refuses_what_the_kernel_does_not_take(dev):
    x, w, b = _inputs((2, 8, 8, 64), dev)
    flat = torch.zeros(x.numel() + 1, dtype=torch.bfloat16, device=dev)
    shifted = flat[1:].view(x.shape)  # 2 bytes off a 16-byte boundary
    n = group_norm_act.launches
    with pytest.raises(TypeError, match="bfloat16"):
        group_norm_act(x.half(), w, b, 8)
    with pytest.raises(TypeError, match="bfloat16"):
        group_norm_act(x.float(), w, b, 8)
    with pytest.raises(ValueError, match="C % 8"):
        group_norm_act(x[..., :60].contiguous(), w[:60], b[:60], 6)
    with pytest.raises(ValueError, match="aligned"):
        group_norm_act(shifted, w, b, 8)
    with pytest.raises(ValueError, match="contiguous"):
        group_norm_act(x.transpose(1, 2), w, b, 8)
    assert group_norm_act.launches == n


_KERNELS_PER_CALL = """
import json, torch
from diffusionmodel_tpu_torch.kernels.group_norm import group_norm_act
from diffusionmodel_tpu_torch.nn.blocks import GroupNorm
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
x = torch.randn((4, 32, 32, 384), device="cuda").bfloat16()
w, b = torch.ones(384, device="cuda"), torch.zeros(384, device="cuda")
norm = GroupNorm(8, 384, compute_dtype=torch.bfloat16, act="gelu",
                 use_pallas=True).cuda()
xm = x.permute(0, 3, 1, 2)
names = {}
for key, fn in (("wrapper", lambda: group_norm_act(x, w, b, 8, 1e-5, "gelu")),
                ("module", lambda: norm(xm))):
    with torch.no_grad():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    names[key] = sorted({(e.name, e.time_range.start) for e in prof.events()
                         if e.device_type == DeviceType.CUDA
                         and e.time_range.end > e.time_range.start})
print("NAMES " + json.dumps(names))
"""


def test_one_launch_per_call(dev):
    """The wrapper and an eval GroupNorm module call launch the one kernel
    and nothing else (no layout copy, no cast), counted by torch.profiler
    in a process of its own (in a long process it reads short)."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _KERNELS_PER_CALL],
                          capture_output=True, text=True, timeout=600,
                          cwd=root)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("NAMES ")]
    assert proc.returncode == 0 and len(lines) == 1, proc.stderr[-3000:]
    for key, names in json.loads(lines[0][len("NAMES "):]).items():
        assert len(names) == 1 and "gn_act" in names[0][0], (key, names)


def test_module_dispatch_on_the_card(dev):
    """GroupNorm takes the kernel for bf16 inference on a whole map with
    ``use_pallas`` only: not without it, not with gradients, not at
    float32, not for float32 x."""
    x, _, _ = _inputs((2, 16, 16, 64), dev)
    xm = x.permute(0, 3, 1, 2)
    norm = GroupNorm(8, 64, compute_dtype=torch.bfloat16, act="gelu",
                     use_pallas=True).to(dev)
    n = group_norm_act.launches
    with torch.no_grad():
        fused = norm(xm)
        assert group_norm_act.launches == n + 1
        assert fused.dtype == torch.bfloat16
        assert fused.is_contiguous(memory_format=torch.channels_last)
        norm(xm.float())
        GroupNorm(8, 64, act="gelu", use_pallas=True).to(dev)(xm.float())
        GroupNorm(8, 64, compute_dtype=torch.bfloat16, act="gelu").to(dev)(xm)
    plain = norm(xm)  # gradients on: the plain path
    assert group_norm_act.launches == n + 1
    assert _same_share(fused, plain) >= SAME_SHARE


def test_flagship_sampling_forward_fuses_every_group_norm(dev):
    """Over the flagship's sampling forwards (preset "full", bf16, SE and
    CoordAttn kernels; DPM++ through ``make_sampler``), the counter
    ``group_norm.fused_calls`` rises by the 36 GroupNorm sites of each
    forward; a train-mode forward with gradients adds none, and neither
    does a sampling forward of the same model without ``use_pallas``."""
    from diffusionmodel_tpu_torch.config import preset
    from diffusionmodel_tpu_torch.diffusion import Schedule
    from diffusionmodel_tpu_torch.nn import build_model
    from diffusionmodel_tpu_torch.trainer import make_sampler

    cfg = preset("full", **{"model.use_pallas": True,
                            "model.dtype": "bfloat16",
                            "model.fused_upsample": True,
                            "sample.sampler": "dpmpp", "sample.dpm_steps": 2})
    torch.manual_seed(0)
    model = build_model(cfg.model, cfg.diffusion.high_thresh, device=dev)
    norms = [m for m in model.modules() if isinstance(m, GroupNorm)]
    forwards = []
    model.register_forward_pre_hook(lambda m, a: forwards.append(1))
    dc = cfg.diffusion
    sched = Schedule.create(dc.beta1, dc.beta2, dc.n_T, dev)
    sampler = make_sampler(cfg, sched, 2, classes=[0, 3])
    tracing.enable()
    try:
        before = tracing.drain()[1].get("group_norm.fused_calls", 0)
        images = sampler(model, torch.Generator(device=dev).manual_seed(1),
                         2.0)
        torch.cuda.synchronize()
        fused = tracing.drain()[1].get("group_norm.fused_calls", 0) - before
        assert len(forwards) > 0 and fused == 36 * len(forwards), \
            (fused, len(forwards), len(norms))
        model.train()
        g = torch.Generator(device=dev).manual_seed(2)
        x = torch.randn((2, 256, 256, 3), generator=g, device=dev)
        n = group_norm_act.launches
        model(x, torch.tensor([0, 1], device=dev),
              torch.full((2,), 0.5, device=dev), torch.ones(2, device=dev))
        assert group_norm_act.launches == n
        cfg = preset("full", **{"model.dtype": "bfloat16",
                                "model.fused_upsample": True})
        plain = build_model(cfg.model, cfg.diffusion.high_thresh, device=dev)
        plain.load_state_dict(model.state_dict())
        with torch.no_grad():
            plain.eval()(x, torch.tensor([0, 1], device=dev),
                         torch.full((2,), 0.5, device=dev),
                         torch.ones(2, device=dev))
        assert group_norm_act.launches == n
    finally:
        tracing.disable()
        tracing.drain()
    assert torch.isfinite(images.float()).all()


def test_activation_of_every_bf16_value_is_the_bf16_programs(dev):
    """With a zero weight the normalised output is the bias, exactly: 16
    calls of 4096 channels hand the kernel every bf16 value as y, and its
    GELU (through the erfc table) and ReLU must be the bf16 program's, bit
    for bit (NaNs stay NaN)."""
    x = torch.zeros((2, 1, 2, 4096), dtype=torch.bfloat16, device=dev)
    w = torch.zeros(4096, device=dev)
    with torch.no_grad():
        for k in range(16):
            bits = torch.arange(k * 4096, (k + 1) * 4096, dtype=torch.int32,
                                device=dev)
            y = (bits - 65536 * (bits >= 32768).int()).short().view(
                torch.bfloat16)
            for act in ("gelu", "relu"):
                got = group_norm_act(x, w, y.float(), 32, 1e-5, act)
                want = activation(y.expand_as(got), act)
                nan = torch.isnan(want)
                assert torch.equal(torch.isnan(got), nan), (k, act)
                assert torch.equal(got[~nan], want[~nan]), (k, act)
