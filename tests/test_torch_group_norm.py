"""GroupNorm with its activation (``nn.blocks.GroupNorm.act``) and the
GroupNorm + activation kernel's wrapper on the CPU: the fused module
against the norm followed by the activation's own module, bit for bit; a
ContextUnet wired with ``act`` against one wired the old way; the module's
dispatch (``use_pallas``, gradients, the kernel's shape limits) with the
device check mocked; the wrapper's dispatch and refusals; the launch
plan. The CUDA kernel itself is held to its twin on the card
(tests/test_torch_group_norm_cuda.py, chip_smoke.py)."""

import contextlib
import copy
import re
from pathlib import Path

import pytest
import torch
import torch.nn as nn

from diffusionmodel_tpu_torch.kernels import group_norm as gn
from diffusionmodel_tpu_torch.kernels.group_norm import (
    group_norm_act,
    group_norm_act_plain,
    launch_plan,
    takes,
)
from diffusionmodel_tpu_torch.nn import blocks
from diffusionmodel_tpu_torch.nn.blocks import (
    GELU,
    GroupNorm,
    channels_last,
    precast_params,
)
from diffusionmodel_tpu_torch.nn.context_unet import ContextUnet

torch.set_num_threads(2)

BF16, F32 = torch.bfloat16, torch.float32
REPO = Path(__file__).resolve().parents[1]


def _norm_pair(c, groups, act, dtype, seed=0):
    """GroupNorm(act) and Sequential(GroupNorm, the activation's module)
    with the same random affine."""
    fused = GroupNorm(groups, c, compute_dtype=dtype, act=act)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        fused.weight.copy_(1 + 0.2 * torch.randn(c, generator=g))
        fused.bias.copy_(0.2 * torch.randn(c, generator=g))
    plain = copy.deepcopy(fused)
    plain.act = None
    pair = nn.Sequential(plain, GELU() if act == "gelu" else nn.ReLU())
    return fused, pair


def _grads(module, x, out):
    grads = torch.autograd.grad(out.float().square().sum(),
                                [x, *module.parameters()])
    return [g.clone() for g in grads]


CASES = [(dt, act, mode, pre) for dt in (F32, BF16) for act in ("gelu", "relu")
         for mode in ("train", "eval") for pre in ((False, True) if dt == BF16
                                                   else (False,))]


@pytest.mark.parametrize("dtype,act,mode,precast", CASES)
def test_group_norm_act_equals_norm_then_activation_module(dtype, act, mode,
                                                           precast):
    fused, pair = _norm_pair(24, 4, act, dtype)
    for m in (fused, pair):
        m.train(mode == "train")
    g = torch.Generator().manual_seed(1)
    x0 = channels_last(0.5 + 2 * torch.randn(3, 24, 6, 5, generator=g))
    x0 = x0.to(dtype)
    outs, grads = [], []
    for m in (fused, pair):
        ctx = precast_params(m) if precast else contextlib.nullcontext()
        x = x0.clone().requires_grad_(True)
        with ctx:
            y = m(x)
            grads.append(_grads(m, x, y))
            with torch.no_grad():
                outs += [y, m(x0)]
    assert outs[0].dtype == dtype
    assert outs[0].is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(outs[0], outs[2]) and torch.equal(outs[1], outs[3])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def _old_wiring(model):
    """A copy of ``model`` with every GroupNorm's activation moved back into
    its own module in the slot after it, as the blocks were wired before
    ``GroupNorm.act``."""
    old = copy.deepcopy(model)
    moved = 0
    for seq in old.modules():
        if not isinstance(seq, nn.Sequential):
            continue
        for i in range(len(seq) - 1):
            norm = seq[i]
            if isinstance(norm, GroupNorm) and norm.act is not None:
                assert isinstance(seq[i + 1], nn.Identity)
                seq[i + 1] = GELU() if norm.act == "gelu" else nn.ReLU()
                norm.act = None
                moved += 1
    return old, moved


def _tiny_unet(dtype):
    torch.manual_seed(0)
    model = ContextUnet(in_ch=3, n_feat=16, n_classes=3, img_size=32,
                        dtype=dtype)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.split(".")[-1] in ("gamma_h", "gamma_w", "alpha",
                                       "beta"):
                p.copy_(torch.randn(p.shape, generator=g))
    return model


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_context_unet_wired_with_act_equals_the_old_wiring(dtype):
    model = _tiny_unet(dtype)
    old, moved = _old_wiring(model)
    # 2 per ResConvBlock (1 + 4 down + 8 up) + 2 a down stage + the local
    # enhancer, up0 and out
    assert moved == 2 * 13 + 2 * 4 + 3
    assert list(model.state_dict()) == list(old.state_dict())
    keys = set(model.state_dict())
    for k in ("init_conv.conv1.1.weight", "down1.channel_compress.1.weight",
              "down1.down.1.bias", "local_enhance.conv.1.weight",
              "up0.1.weight", "out.1.bias"):
        assert k in keys
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 32, 32, 3, generator=g)
    c = torch.tensor([0, 2])
    t = torch.tensor([0.3, 0.7])
    mask = torch.tensor([1.0, 0.0])
    attn = torch.rand(2, 32, 32, generator=g) * 2
    for m in (model, old):
        m.eval()
    with torch.no_grad():
        assert torch.equal(model(x, c, t, mask), old(x, c, t, mask))
    for m in (model, old):
        m.train()
    outs = [m(x, c, t, mask, attn) for m in (model, old)]
    assert torch.equal(outs[0], outs[1])
    grads = [torch.autograd.grad(o.float().square().sum(), m.parameters(),
                                 allow_unused=True)
             for o, m in zip(outs, (model, old))]
    for a, b in zip(*grads):
        assert (a is None and b is None) or torch.equal(a, b)


def _mock_card(monkeypatch):
    """``nn.blocks`` sees every tensor as on the card, and its kernel call
    runs the twin on the CPU; returns the list of calls it took."""
    calls = []

    def kernel(x, w, b, groups, eps, act):
        calls.append((tuple(x.shape), groups, act))
        return group_norm_act_plain(x, w, b, groups, eps, act)

    monkeypatch.setattr(blocks, "on_card", lambda x: True)
    monkeypatch.setattr(blocks, "group_norm_act", kernel)
    return calls


def test_module_takes_the_kernel_only_where_it_should(monkeypatch):
    calls = _mock_card(monkeypatch)
    fused, _ = _norm_pair(48, 8, "gelu", BF16)
    fused.use_pallas = True
    plain = copy.deepcopy(fused)
    plain.use_pallas = False
    g = torch.Generator().manual_seed(4)
    x = channels_last(torch.randn(2, 48, 5, 7, generator=g)).to(BF16)
    with torch.no_grad():
        y = fused(x)
        assert calls == [((2, 5, 7, 48), 8, "gelu")]
        assert y.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(y, plain(x))  # no use_pallas: the plain ops
        fused(x.float())  # float32 x
        f32 = GroupNorm(8, 48, act="gelu", use_pallas=True)
        f32(x)  # float32 compute
    assert len(calls) == 1
    assert torch.equal(fused(x), y)  # gradients on: the plain ops
    assert len(calls) == 1


def test_module_keeps_shapes_past_the_kernels_limits_plain(monkeypatch):
    """A group of more than 2**24 values (here 1024 channels in one group
    over 128 x 130 pixels; the flagship's 24-channel groups at 1024 px are
    another) keeps the plain ops instead of reaching a kernel that would
    refuse it; one pixel fewer a row takes the kernel."""
    calls = _mock_card(monkeypatch)
    norm = GroupNorm(1, 1024, compute_dtype=BF16, act="relu", use_pallas=True)
    assert not takes(1, 1024, 1024, 192, 8)
    for w, taken in ((130, False), (128, True)):
        assert takes(1, 128, w, 1024, 1) == taken
        g = torch.Generator().manual_seed(w)
        x = channels_last(torch.randn(1, 1024, 128, w, generator=g)).to(BF16)
        with torch.no_grad():
            y = norm(x)
        assert len(calls) == int(taken)
        assert y.dtype == BF16 and y.shape == x.shape
        del x, y


@pytest.mark.parametrize("use_pallas", [False, True])
def test_context_unet_takes_the_kernel_only_with_use_pallas(use_pallas,
                                                            monkeypatch):
    """A bf16 ContextUnet's sampling forward reaches the kernel at its 36
    GroupNorm + activation sites with ``use_pallas`` (none of CoordAttn's
    norms) and nowhere without it, with the same output either way."""
    torch.manual_seed(0)
    model = ContextUnet(in_ch=3, n_feat=32, n_classes=3, img_size=32,
                        use_pallas=use_pallas, dtype=BF16).eval()
    g = torch.Generator().manual_seed(6)
    args = (torch.randn(2, 32, 32, 3, generator=g), torch.tensor([0, 2]),
            torch.tensor([0.3, 0.7]), torch.tensor([1.0, 0.0]))
    with torch.no_grad():
        want = model(*args)
        calls = _mock_card(monkeypatch)
        got = model(*args)
    assert len(calls) == (36 if use_pallas else 0)
    assert all(act in ("gelu", "relu") for _, _, act in calls)
    assert torch.equal(got, want)


def test_wrapper_sends_cpu_tensors_to_the_twin():
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 5, 7, 48, generator=g).to(BF16)
    w, b = 1 + torch.randn(48, generator=g), torch.randn(48, generator=g)
    n = group_norm_act.launches
    for act in (None, "gelu", "relu"):
        got = group_norm_act(x, w, b, 8, 1e-5, act)
        assert torch.equal(got, group_norm_act_plain(x, w, b, 8, 1e-5, act))
        assert got.dtype == BF16 and got.shape == x.shape
    assert group_norm_act.launches == n


def _meta(shape, dtype=BF16):
    return torch.empty(shape, dtype=dtype, device="meta")


REFUSALS = [
    ("float16", lambda: (_meta((2, 4, 4, 64), torch.float16), 8, None),
     TypeError),
    ("float32", lambda: (_meta((2, 4, 4, 64), F32), 8, None), TypeError),
    ("c_mod_8", lambda: (_meta((2, 4, 4, 60)), 6, None), ValueError),
    ("groups", lambda: (_meta((2, 4, 4, 64)), 6, None), ValueError),
    ("wide", lambda: (_meta((1, 2, 2, 8200)), 8, None), ValueError),
    ("nchw", lambda: (_meta((2, 64, 4, 4)).permute(0, 2, 3, 1), 8, None),
     ValueError),
    ("rank", lambda: (_meta((2, 16, 64)), 8, None), ValueError),
    ("act", lambda: (_meta((2, 4, 4, 64)), 8, "silu"), ValueError),
    ("group_over_2_24", lambda: (_meta((1, 1024, 1024, 192)), 8, None),
     ValueError),
]


@pytest.mark.parametrize("case", REFUSALS, ids=[r[0] for r in REFUSALS])
def test_wrapper_refuses_what_the_kernel_does_not_take(case, monkeypatch):
    _, make, exc = case
    launched = []
    monkeypatch.setattr(gn, "on_card", lambda x: True)
    monkeypatch.setattr(gn, "_launch", lambda *a: launched.append(a))
    x, groups, act = make()
    c = x.shape[-1]
    w = torch.empty(c, device="meta")
    with pytest.raises(exc):
        group_norm_act(x, w, w, groups, 1e-5, act)
    assert not launched
    # the same call with an x the kernel takes reaches the launch
    group_norm_act(_meta((2, 4, 4, 64)), torch.empty(64, device="meta"),
                   torch.empty(64, device="meta"), 8, 1e-5, "gelu")
    assert len(launched) == 1


def test_wrapper_refuses_other_devices():
    x = _meta((1, 4, 4, 64))
    w = torch.empty(64, device="meta")
    with pytest.raises(ValueError, match="device"):
        group_norm_act(x, w, w, 8)


# The flagship's GroupNorm sites (n_feat 192, 256 px) as (H, C), and ragged
# shapes: a part off the lanes, C off a power of two, one pixel.
FLAGSHIP_SITES = [(256, 192), (256, 48), (128, 48), (128, 384), (64, 96),
                  (64, 768), (32, 192), (32, 1536), (16, 1536), (32, 768),
                  (64, 384), (128, 192)]
RAGGED = [(7, 40), (5, 8), (1, 4096), (3, 2048)]


@pytest.mark.parametrize("hc", FLAGSHIP_SITES + RAGGED)
def test_launch_plan(hc):
    h, c = hc
    plans = [launch_plan(b, h, h + 1, c, 8, 132, per_sm)
             for b in (1, 16) for per_sm in (1, 2)]
    p = plans[-1]
    hw = h * (h + 1)
    # the partition depends on (H, W, C) alone
    for q in plans:
        assert (q.lanes, q.threads, q.part_pixels, q.parts, q.smem) == \
            (p.lanes, p.threads, p.part_pixels, p.parts, p.smem)
    assert p.vectors * 8 == c
    assert p.lanes * p.vectors <= p.threads <= gn.MAX_THREADS
    assert p.threads % 32 == 0 and p.threads - p.lanes * p.vectors < 32
    assert gn.MAX_THREADS - p.lanes * p.vectors < p.vectors
    assert 1 <= p.parts <= gn.MAX_PARTS
    assert (p.parts - 1) * p.part_pixels < hw <= p.parts * p.part_pixels
    assert p.part_pixels * 2 * c >= min(gn.PART_BYTES, hw * 2 * c)
    assert p.smem <= 48 * 1024  # no opt-in above the default
    assert gn.smem_bytes(gn.MAX_THREADS, 8, gn.MAX_GROUPS) <= 48 * 1024
    assert plans[0].grid == min(p.parts, 132)
    assert plans[1].grid == min(p.parts, 264)
    assert p.grid == min(16 * p.parts, 264) and p.grid >= p.parts
    assert p.words == 2 * 16 * p.parts * 8
    assert p.bytes_written == 16 * hw * c * 2


@pytest.mark.parametrize("sms", [114, 66, 1])
def test_launch_plan_on_a_card_of_fewer_blocks(sms):
    """A card holding fewer blocks than MAX_PARTS at once cuts a sample
    into at most that many parts, and as the H100 SXM does where that
    fits; the partition still ignores the batch."""
    for h, c in FLAGSHIP_SITES + RAGGED:
        plans = [launch_plan(b, h, h, c, 8, sms, 1) for b in (1, 16)]
        p = plans[0]
        assert p.parts <= sms and p.grid >= p.parts
        assert (p.parts - 1) * p.part_pixels < h * h <= p.parts * p.part_pixels
        assert (plans[1].part_pixels, plans[1].parts) == (p.part_pixels,
                                                          p.parts)
        full = launch_plan(1, h, h, c, 8)  # the H100 SXM's 132 SMs
        if full.parts <= sms:  # cut as there where it fits
            assert (full.part_pixels, full.parts) == (p.part_pixels, p.parts)
        else:
            assert p.parts == sms or p.part_pixels > full.part_pixels


SHAPES = [(b, h, w, c, groups) for b in (0, 1) for h, w in ((0, 4), (4, 4),
                                                           (4096, 4096))
          for c, groups in ((8, 8), (12, 4), (64, 6), (4096, 1), (8192, 8),
                            (2048, 2048), (192, 8))]


def test_takes_is_what_launch_plan_accepts():
    for shape in SHAPES:
        try:
            launch_plan(*shape)
            accepted = True
        except ValueError:
            accepted = False
        assert takes(*shape) == accepted, shape
    assert sum(takes(*shape) for shape in SHAPES) > 0


def test_launch_plan_refusals():
    with pytest.raises(ValueError):
        launch_plan(1, 4, 4, 12, 4)  # C % 8
    with pytest.raises(ValueError):
        launch_plan(1, 4, 4, 64, 6)  # C % groups
    with pytest.raises(ValueError):
        launch_plan(1, 4, 4, 8192, 8)  # C over the block
    with pytest.raises(ValueError):
        launch_plan(1, 1024, 1024, 256, 8)  # 2**25 values a group


def test_kernel_constants_match_the_python_side():
    src = (REPO / "diffusionmodel_tpu_torch" / "kernels" / "csrc"
           / "group_norm.cu").read_text()
    neg = float(re.search(r"kNegSqrtHalf = (-[0-9.]+)f;", src).group(1))
    assert neg == torch.tensor(-0.5 ** 0.5, dtype=BF16).item()
    bits = torch.tensor(neg, dtype=BF16).view(torch.int16).item() & 0xFFFF
    assert f"kNegSqrtHalf2 = 0x{bits:04X}{bits:04X}u;" in src
    assert f"kMaxThreads = {gn.MAX_THREADS};" in src
    assert f"kMaxGroups = {gn.MAX_GROUPS};" in src
    assert int(re.search(r"kMaxParts = (\d+);", src).group(1)) >= gn.MAX_PARTS
    assert ("return 4 * (2 * (size_t)lanes * c + 2 * (size_t)groups) + "
            "2 * kErfcTable;") in src
    assert "kErfcTable = 2 * kErfcExps * 128;" in src
    assert "kErfcExp0 = 115, kErfcExps = 16;" in src
    assert gn.ERFC_TABLE == 2 * 16 * 128
    assert gn.smem_bytes(3, 64, 8) == 4 * (2 * 3 * 64 + 2 * 8) + 2 * 4096
    for act, code in gn.ACTS.items():
        name = {None: "kNone", "gelu": "kGelu", "relu": "kRelu"}[act]
        assert re.search(rf"\b{name} = {code}\b", src)
