"""The port's CUDA kernels on the card, held to their plain twins.

Marked ``cuda``: every test here skips where CUDA is absent (the CPU
tier). On a machine with a card, where JAX is not installed, run them
without the repository's conftest (it imports jax):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

The bf16 forms of SE and CoordAttn are held to their bf16 twins: the
same float32 arithmetic inside and one rounding of the output, so
relative L2 <= 4e-3 and max |diff| <= 2**-7 of max |y| (about one bf16 ulp
at the top of the range, where a float32 sum lands a value on the other
side of a rounding boundary).

Tolerance: max |kernel - twin| <= 1e-4 on standard-normal inputs. Both
compute in fp32 (TF32 is switched off for the twin's products); the
kernels sum in another order, which moves results by ~1e-6. The flash
kernels form each product from three TF32 tensor-core products (3xTF32),
accurate to about fp32. The flash backward's gradients are sums over a
whole sequence and grow with it, so they are held to 1e-4 of the largest
reference value instead.
"""

import pytest
import torch

from diffusionmodel_tpu_torch.kernels.coord_attn import (
    CoordAttnWeights,
    coord_attn,
    coord_attn_plain,
)
from diffusionmodel_tpu_torch.kernels.flash_attn import (
    flash_attention,
    flash_attention_backward,
    flash_attention_backward_plain,
    flash_attention_dkv,
    flash_attention_dq,
    flash_attention_plain,
)
from diffusionmodel_tpu_torch.kernels.se_block import se_block, se_block_plain
from diffusionmodel_tpu_torch.models.latent_diffusion.unet import UNetModel
from diffusionmodel_tpu_torch.nn.blocks import SEBlock, channels_last, gn_groups
from diffusionmodel_tpu_torch.nn.coord_attn import CoordAttn
from diffusionmodel_tpu_torch.nn.context_unet import ContextUnet

pytestmark = pytest.mark.cuda

ATOL = 1e-4
# Flagship sites (n_feat 192, 256 px) at batch 2, plus odd widths.
SE_SHAPES = [(2, 256, 256, 192), (2, 128, 128, 384), (2, 64, 64, 768),
             (2, 32, 32, 1536), (3, 5, 7, 20), (1, 1, 1, 4)]
CA_SHAPES = [(2, 128, 128, 192), (2, 64, 64, 384), (2, 32, 32, 768),
             (2, 16, 16, 1536), (3, 9, 9, 32), (1, 256, 256, 64),
             # ragged: L off the 16-row tiles, C off the 32-channel chunks,
             # L = 1, C over two of the bottleneck's k-slices
             (3, 20, 20, 96), (2, 9, 9, 80), (2, 1, 1, 64), (2, 20, 20, 400)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _se_inputs(shape, dev, seed=0):
    b, h, w, c = shape
    r = max(1, c // 16)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=dev)
    w1 = torch.randn((c, r), generator=g, device=dev) / c ** 0.5
    w2 = torch.randn((r, c), generator=g, device=dev) / r ** 0.5
    return x, w1, w2


def _ca_module(c, norm, dev, seed=0):
    torch.manual_seed(seed)
    mod = CoordAttn(c, 16, norm=norm).to(dev).eval()
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    with torch.no_grad():
        for p in (mod.gamma_h, mod.gamma_w, mod.alpha, mod.beta):
            p.copy_(torch.randn(1, generator=g, device=dev))
        for nl in (mod.bn1_h, mod.bn1_w):
            n = nl.weight.shape[0]
            nl.weight.copy_(1 + 0.1 * torch.randn(n, generator=g, device=dev))
            nl.bias.copy_(0.1 * torch.randn(n, generator=g, device=dev))
            if norm == "batch":
                nl.running_mean.copy_(
                    0.1 * torch.randn(n, generator=g, device=dev))
                nl.running_var.copy_(
                    torch.rand(n, generator=g, device=dev) + 0.5)
    return mod


# Profiled first: on the card, torch.profiler drops device events once a
# process has kept the card busy for a while (chip_smoke.fresh_kernel_counts).
def _cuda_kernels(fn):
    """The CUDA kernels one call of ``fn`` launches, by torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({(e.name, e.time_range.start) for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and e.time_range.end > e.time_range.start})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_se_launches_one_kernel_per_call(dev, dtype):
    w1, w2 = _se_linear(384, dev)
    x = torch.randn((4, 32, 32, 384), device=dev).to(dtype)
    names = _cuda_kernels(lambda: se_block(x, w1, w2))
    assert len(names) == 1 and "se_fused" in names[0][0], names


def test_se_module_eval_forward_launches_no_copy(dev):
    """An eval SEBlock call passes its nn.Linear weights as they are: one
    kernel, no weight copy, no layout copy of x."""
    se = SEBlock(192, 16, use_pallas=True).to(dev).eval()
    x = channels_last(torch.randn(2, 192, 16, 16, device=dev))
    with torch.no_grad():
        names = _cuda_kernels(lambda: se(x))
    assert len(names) == 1 and "se_fused" in names[0][0], names

@pytest.mark.parametrize("shape", SE_SHAPES)
def test_se_kernel_matches_twin(dev, shape):
    x, w1, w2 = _se_inputs(shape, dev)
    n = se_block.launches
    got = se_block(x, w1, w2)
    torch.cuda.synchronize()
    assert se_block.launches == n + 1
    want = se_block_plain(x, w1, w2)
    assert (got - want).abs().max().item() <= ATOL
    # fixed summation order: bit-identical reruns, and a sample's output
    # does not depend on what else is in its batch
    assert torch.equal(se_block(x, w1, w2), got)
    assert torch.equal(se_block(x[-1:].contiguous(), w1, w2), got[-1:])


# SE shapes off the kernel's tiles: H*W not a multiple of a tile, C off
# the 128-byte rows (200, 1040), B = 1, 5 and 16.
SE_RAGGED = [(5, 37, 29, 64), (16, 23, 23, 200), (1, 130, 130, 192),
             (2, 96, 96, 1040)]


def _se_linear(c, dev, seed=0):
    """w1 [C, R] and w2 [R, C] as SEBlock hands them over: transposed
    views of nn.Linear weights (the kernel reads them without a copy)."""
    r = max(1, c // 16)
    g = torch.Generator(device=dev).manual_seed(seed)
    w1 = torch.randn((r, c), generator=g, device=dev) / c ** 0.5
    w2 = torch.randn((c, r), generator=g, device=dev) / r ** 0.5
    return w1.t(), w2.t()


def _se_close(got, want):
    if want.dtype == torch.bfloat16:
        _bf16_close(got, want)
    else:
        assert (got - want).abs().max().item() <= ATOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SE_RAGGED)
def test_se_kernel_ragged_matches_twin(dev, shape, dtype):
    w1, w2 = _se_linear(shape[-1], dev, 1)
    x = torch.randn(shape, generator=torch.Generator(device=dev)
                    .manual_seed(2), device=dev).to(dtype)
    got = se_block(x, w1, w2)
    _se_close(got, se_block_plain(x, w1, w2))
    assert torch.equal(se_block(x, w1, w2), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [5, 16])
def test_se_kernel_rows_alone_match_the_batch(dev, b, dtype):
    """Tiles, parts and sums depend on (H, W, C) only: row k of a batch is
    bit-identical to x[k:k+1] alone (the serving contract)."""
    w1, w2 = _se_linear(1536, dev, 3)
    x = torch.randn((b, 32, 32, 1536), generator=torch.Generator(device=dev)
                    .manual_seed(4), device=dev).to(dtype)
    got = se_block(x, w1, w2)
    for k in range(b):
        assert torch.equal(se_block(x[k:k + 1].contiguous(), w1, w2),
                           got[k:k + 1])


def test_se_calls_of_other_shapes_in_turn(dev):
    """Calls on one stream share one workspace (counters, flags, scratch)
    across plans and types: a counter or flag left set would hang or give a
    wrong gate."""
    cases = []
    for i, (shape, dtype) in enumerate((
            ((2, 32, 32, 1536), torch.bfloat16),
            ((5, 64, 64, 768), torch.float32),
            ((3, 20, 20, 96), torch.bfloat16),
            ((16, 16, 16, 192), torch.float32))):
        w1, w2 = _se_linear(shape[-1], dev, 10 + i)
        x = torch.randn(shape, device=dev).to(dtype)
        cases.append((x, w1, w2, se_block_plain(x, w1, w2)))
    for _ in range(3):
        for x, w1, w2, want in cases:
            _se_close(se_block(x, w1, w2), want)
    torch.cuda.synchronize()


@pytest.mark.parametrize("kind", ["group", "affine"])
@pytest.mark.parametrize("shape", CA_SHAPES)
def test_coord_attn_kernel_matches_twin(dev, shape, kind):
    c = shape[-1]
    mod = _ca_module(c, "group" if kind == "group" else "batch", dev)
    wts = CoordAttnWeights.from_module(mod, kind)
    groups = gn_groups(c // 16, 8)
    x = torch.randn(shape, generator=torch.Generator(device=dev)
                    .manual_seed(2), device=dev)
    n = coord_attn.launches
    with torch.no_grad():
        got = coord_attn(x, wts, kind, groups)
        torch.cuda.synchronize()
        assert coord_attn.launches == n + 1
        want = coord_attn_plain(x, wts, kind, groups)
        assert (got - want).abs().max().item() <= ATOL
        assert torch.equal(coord_attn(x, wts, kind, groups), got)
        assert torch.equal(coord_attn(x[-1:].contiguous(), wts, kind, groups),
                           got[-1:])


def test_coord_attn_calls_of_other_shapes_in_turn(dev):
    """Calls on one stream reuse one workspace (counters and scratch) across
    shapes with other launch plans: each still matches its twin."""
    cases = []
    for shape, kind in (((2, 32, 32, 768), "affine"),
                        ((2, 16, 16, 1536), "group"), ((3, 20, 20, 96), "group")):
        mod = _ca_module(shape[-1], "group" if kind == "group" else "batch",
                         dev)
        x = torch.randn(shape, generator=torch.Generator(device=dev)
                        .manual_seed(3), device=dev)
        cases.append((x, CoordAttnWeights.from_module(mod, kind), kind,
                      gn_groups(shape[-1] // 16, 8)))
    with torch.no_grad():
        for _ in range(3):
            for x, wts, kind, groups in cases:
                got = coord_attn(x, wts, kind, groups)
                want = coord_attn_plain(x, wts, kind, groups)
                assert (got - want).abs().max().item() <= ATOL


def test_coord_attn_launches_three_kernels_per_call(dev):
    """pool, bottleneck (with the last-block mix) and apply (with the output
    projection): three kernels, nothing else, per call, for fp32 and bf16
    x (pool and apply are templated on x's type)."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    mod = _ca_module(192, "group", dev)
    wts = CoordAttnWeights.from_module(mod)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((2, 32, 32, 192), device=dev).to(dtype)
        with torch.no_grad():
            coord_attn(x, wts, "group", 6)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                coord_attn(x, wts, "group", 6)
                torch.cuda.synchronize()
        names = sorted({(e.name, e.time_range.start) for e in prof.events()
                        if e.device_type == DeviceType.CUDA
                        and e.time_range.end > e.time_range.start})
        assert len(names) == 3, names
        short = sorted(re.search(r"\bca_[a-z_]+(?=[(<])", n).group(0)
                       for n, _ in names)
        assert short == ["ca_apply", "ca_bottleneck", "ca_pool"], names


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x, w1, w2 = _se_inputs((2, 8, 8, 64), dev)
    wts = CoordAttnWeights.from_module(_ca_module(64, "group", dev))
    with pytest.raises(ValueError, match="contiguous"):
        se_block(x.transpose(1, 2), w1, w2)
    with pytest.raises(TypeError, match="float32"):
        se_block(x.half(), w1, w2)
    with pytest.raises(ValueError, match="C % 4"):
        se_block(x[..., :62].contiguous(), w1[:62], w2[:, :62])
    with pytest.raises(ValueError, match="square"):
        coord_attn(x[:, :4].contiguous(), wts, "group", 4)
    with pytest.raises(ValueError, match="contiguous"):
        coord_attn(x.transpose(1, 2), wts, "group", 4)
    big = torch.zeros((1, 264, 264, 64), device=dev)
    with pytest.raises(ValueError, match="side"):
        coord_attn(big, wts, "group", 4)


# Two flagship sites of each kernel at batch 2: the widest and the deepest.
BF16_SE_SHAPES = [(2, 256, 256, 192), (2, 32, 32, 1536)]
BF16_CA_SHAPES = [(2, 128, 128, 192), (2, 16, 16, 1536)]


def _bf16_close(got, want):
    assert got.dtype == want.dtype == torch.bfloat16
    got, want = got.float(), want.float()
    assert ((got - want).norm() / want.norm()).item() <= 4e-3
    assert (got - want).abs().max().item() <= 2 ** -7 * want.abs().max()


@pytest.mark.parametrize("shape", BF16_SE_SHAPES)
def test_se_kernel_bf16_matches_twin(dev, shape):
    x, w1, w2 = _se_inputs(shape, dev)
    x = x.bfloat16()
    n = se_block.launches
    got = se_block(x, w1, w2)
    torch.cuda.synchronize()
    assert se_block.launches == n + 1
    _bf16_close(got, se_block_plain(x, w1, w2))
    assert torch.equal(se_block(x, w1, w2), got)
    assert torch.equal(se_block(x[-1:].contiguous(), w1, w2), got[-1:])


@pytest.mark.parametrize("shape", BF16_CA_SHAPES)
def test_coord_attn_kernel_bf16_matches_twin(dev, shape):
    c = shape[-1]
    wts = CoordAttnWeights.from_module(_ca_module(c, "group", dev), "group")
    groups = gn_groups(c // 16, 8)
    x = torch.randn(shape, generator=torch.Generator(device=dev)
                    .manual_seed(2), device=dev).bfloat16()
    n = coord_attn.launches
    with torch.no_grad():
        got = coord_attn(x, wts, "group", groups)
        torch.cuda.synchronize()
        assert coord_attn.launches == n + 1
        _bf16_close(got, coord_attn_plain(x, wts, "group", groups))
        assert torch.equal(coord_attn(x, wts, "group", groups), got)
        assert torch.equal(coord_attn(x[-1:].contiguous(), wts, "group",
                                      groups), got[-1:])


def test_bf16_wrappers_refuse_float16_and_unaligned_x(dev):
    """float16 raises TypeError; a bf16 x whose C is not a multiple of 8,
    or that does not start on 16 bytes, raises ValueError: no fallback."""
    x, w1, w2 = _se_inputs((2, 8, 8, 64), dev)
    wts = CoordAttnWeights.from_module(_ca_module(64, "group", dev))
    xb = x.bfloat16()
    flat = torch.zeros(xb.numel() + 1, dtype=torch.bfloat16, device=dev)
    shifted = flat[1:].view(xb.shape)  # 2 bytes off a 16-byte boundary
    n = (se_block.launches, coord_attn.launches)
    for fn in (lambda a: se_block(a, w1[:a.shape[-1]], w2[:, :a.shape[-1]]),
               lambda a: coord_attn(a, wts, "group", 4)):
        with pytest.raises(TypeError, match="bfloat16"):
            fn(x.half())
        with pytest.raises(ValueError, match="C % 8"):
            fn(xb[..., :60].contiguous())
        with pytest.raises(ValueError, match="aligned"):
            fn(shifted)
    assert (se_block.launches, coord_attn.launches) == n


def test_context_unet_bf16_on_the_card(dev):
    """A narrow bf16 flagship with use_pallas: an eval forward launches 5
    SE and 4 CoordAttn kernels on bf16 activations and returns finite
    bf16, within bf16's reach of the fp32 forward; the fused head too."""
    _, m32, _ = _flagship_small(True, dev)
    g = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn((2, 64, 64, 3), generator=g, device=dev)
    args = (x, torch.tensor([0, 3], device=dev),
            torch.full((2,), 0.3, device=dev), torch.ones(2, device=dev))
    with torch.no_grad():
        want = m32.eval()(*args)
        for fused in (False, True):
            _, m16, _ = _flagship_small(True, dev, **{
                "model.dtype": "bfloat16", "model.fused_upsample": fused})
            m16.load_state_dict(m32.state_dict())
            n = (se_block.launches, coord_attn.launches)
            got = m16.eval()(*args)
            torch.cuda.synchronize()
            assert (se_block.launches - n[0], coord_attn.launches - n[1]) \
                == (5, 4)
            assert got.dtype == torch.bfloat16
            assert torch.isfinite(got.float()).all()
            assert ((got.float() - want).norm() / want.norm()).item() < 0.1


def test_modules_dispatch_on_the_card(dev):
    """SE takes the kernel iff use_pallas and eval; CoordAttn takes it iff
    use_pallas and GroupNorm, and its twin in train mode."""
    x = channels_last(torch.randn(2, 64, 16, 16, device=dev))
    se = SEBlock(64, 16, use_pallas=True).to(dev).eval()
    ca = _ca_module(64, "group", dev)
    ca.use_pallas = True
    with torch.no_grad():
        n_se, n_ca = se_block.launches, coord_attn.launches
        se(x), ca(x)
        assert (se_block.launches, coord_attn.launches) == (n_se + 1, n_ca + 1)
        se.train(), ca.train()
        se(x), ca(x)
        assert (se_block.launches, coord_attn.launches) == (n_se + 1, n_ca + 1)


@pytest.mark.parametrize("norm", ["group", "batch"])
def test_context_unet_kernel_path_matches_plain_path(dev, norm):
    kw = dict(in_ch=3, n_feat=16, n_classes=3, img_size=64, norm=norm)
    torch.manual_seed(0)
    plain = ContextUnet(**kw).to(dev).to(memory_format=torch.channels_last)
    fused = ContextUnet(**kw, use_pallas=True).to(dev).to(
        memory_format=torch.channels_last)
    fused.load_state_dict(plain.state_dict())
    plain.eval(), fused.eval()
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((4, 64, 64, 3), generator=g, device=dev)
    c = torch.tensor([0, 1, 2, 0], device=dev)
    t = torch.tensor([0.1, 0.4, 0.7, 1.0], device=dev)
    ctx = torch.tensor([1.0, 0.0, 1.0, 0.0], device=dev)
    with torch.no_grad():
        n_se, n_ca = se_block.launches, coord_attn.launches
        got = fused(x, c, t, ctx)
        torch.cuda.synchronize()
        # five SE sites; CoordAttn's kernel only under GroupNorm
        assert se_block.launches - n_se == 5
        assert coord_attn.launches - n_ca == (4 if norm == "group" else 0)
        want = plain(x, c, t, ctx)
    assert got.shape == (4, 64, 64, 3) and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)


# Flash attention: (B, N, M, H, D) — every head dim the LDM archs send, a
# ragged N (416 px: 52² = 2704 tokens), M != N, and a sequence shorter than
# one tile.
FLASH_SHAPES = [(2, 2704, 2704, 8, 40), (1, 300, 200, 2, 16),
                (1, 1000, 1500, 4, 32), (2, 257, 257, 8, 64),
                (1, 2304, 2304, 8, 80), (1, 2048, 333, 8, 160),
                (3, 17, 5, 1, 40)]


def _qkv(b, n, m, h, d, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((b, n, h, d), generator=g, device=dev),
            torch.randn((b, m, h, d), generator=g, device=dev),
            torch.randn((b, m, h, d), generator=g, device=dev))


@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_kernel_matches_twin(dev, shape):
    q, k, v = _qkv(*shape, dev)
    n = flash_attention.launches
    o, lse = flash_attention(q, k, v, want_lse=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == n + 1
    want_o, want_lse = flash_attention_plain(q, k, v, want_lse=True)
    assert o.shape == q.shape and lse.shape == (shape[0], shape[3], shape[1])
    assert (o - want_o).abs().max().item() <= ATOL
    assert (lse - want_lse).abs().max().item() <= ATOL
    assert torch.equal(flash_attention(q, k, v), o)


@pytest.mark.parametrize("shape", [(2, 300, 300, 2, 40),
                                   (1, 256, 200, 2, 160)])
def test_flash_kernel_peaked_softmax(dev, shape):
    """q, k x3: a sharply peaked softmax, where one TF32 product per fp32
    product would miss ATOL; the kernel's 3xTF32 products do not."""
    q, k, v = _qkv(*shape, dev)
    q, k = 3 * q, 3 * k
    o, lse = flash_attention(q, k, v, want_lse=True)
    want_o, want_lse = flash_attention_plain(q, k, v, want_lse=True)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    assert (o - want_o).abs().max().item() <= ATOL
    assert (lse - want_lse).abs().max().item() <= ATOL


def test_flash_kernel_runs_are_bit_identical(dev):
    """Each output row is owned by one block and summed in a fixed order."""
    q, k, v = _qkv(2, 2704, 2704, 8, 40, dev, seed=4)
    first = flash_attention(q, k, v, want_lse=True)
    second = flash_attention(q, k, v, want_lse=True)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_flash_kernel_reads_strided_heads(dev):
    """q/k/v as views of one [B, N, 3·H·D] projection, the way a fused
    QKV product would leave them: no copy, same result."""
    b, n, h, d = 2, 300, 4, 40
    qkv = torch.randn((b, n, 3 * h * d), device=dev)
    q, k, v = (t.view(b, n, h, d) for t in qkv.split(h * d, dim=-1))
    assert not q.is_contiguous()
    got = flash_attention(q, k, v)
    want = flash_attention_plain(q, k, v)
    assert (got - want).abs().max().item() <= ATOL


def test_flash_wrapper_refuses_what_the_kernel_does_not_take(dev):
    q, k, v = _qkv(1, 64, 64, 2, 40, dev)
    n = flash_attention.launches
    with pytest.raises(TypeError, match="float32"):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="strides"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(*_qkv(1, 64, 64, 2, 24, dev))
    with pytest.raises(ValueError, match="shape"):
        flash_attention(q, k[:, :, :1], v)
    assert flash_attention.launches == n


def test_ldm_unet_flash_path_matches_plain_path(dev):
    """The tiny LDM UNet with its gate lowered so the kernel runs at every
    level-0 self-attention (2 of them), against the plain path."""
    from diffusionmodel_tpu_torch.models.latent_diffusion.runner import ARCHS

    a = {k: v for k, v in ARCHS["tiny"].items() if not k.startswith("ae_")}
    torch.manual_seed(0)
    unet = UNetModel(flash_min_seq=512, **a).to(dev).to(
        memory_format=torch.channels_last).eval()
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((2, 32, 32, 4), generator=g, device=dev)
    t = torch.tensor([10, 900], device=dev)
    cond = torch.randn((2, 77, a["d_cond"]), generator=g, device=dev)
    with torch.no_grad():
        n = flash_attention.launches
        got = unet(x, t, cond)
        torch.cuda.synchronize()
        assert flash_attention.launches - n == 3  # down_0_0, up_0_{0,1}
        unet.set_use_flash(False)
        want = unet(x, t, cond)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)


BWD_RTOL = 1e-4  # of max |reference|: fp32 sums over N or M in another order


def _rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


# (B, N, M, H, D, scale of q and k): the flash sites, then N and M
# multiples of neither the streamed tile nor 16 at the tile shapes of D =
# 40, 80 and 160, and sharply peaked softmaxes (q, k x3), where one TF32
# product per fp32 product would miss BWD_RTOL.
BWD_CASES = [(*shape, 1.0) for shape in FLASH_SHAPES] + [
    (1, 77, 129, 3, 40, 1.0), (1, 77, 129, 3, 80, 1.0),
    (1, 77, 129, 3, 160, 1.0), (2, 300, 300, 2, 40, 3.0),
    (1, 256, 200, 2, 160, 3.0)]


@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_backward_kernels_match_twin(dev, case):
    """The dQ pass and the dK/dV pass (3xTF32 on the tensor cores) against
    their plain twins, with q, k and v as strided views and ``do`` laid out
    as the UNet's reshape leaves it; two runs agree bit for bit."""
    b, n, m, h, d, scale = case
    q, k, v = _qkv(b, n, m, h, d, dev)
    q, k = q * scale, k * scale
    g = torch.Generator(device=dev).manual_seed(9)
    do = torch.randn((b, n, h, d), generator=g, device=dev)
    o, lse = flash_attention_plain(q, k, v, want_lse=True)
    nq, nkv = flash_attention_dq.launches, flash_attention_dkv.launches
    dq, delta = flash_attention_dq(q, k, v, o, lse, do)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    assert (flash_attention_dq.launches, flash_attention_dkv.launches) == (
        nq + 1, nkv + 1)
    want_dq, want_dk, want_dv = flash_attention_backward_plain(
        q, k, v, o, lse, do)
    want_delta = (do * o).sum(-1).transpose(1, 2)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    assert (delta - want_delta).abs().max().item() <= ATOL
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert got.is_contiguous() and torch.isfinite(got).all()
        assert _rel_err(got, want) <= BWD_RTOL
    again = flash_attention_backward(q, k, v, o, lse, do)
    assert all(torch.equal(a, c) for a, c in zip(again, (dq, dk, dv)))


def test_flash_function_gradients_through_views(dev):
    """Autograd through the Function: q, k, v as views of one projection,
    the output gradient arriving through a reshape, as in the UNet."""
    b, n, h, d = 2, 300, 4, 40
    x = torch.randn((b, n, 3 * h * d), device=dev, requires_grad=True)
    q, k, v = (t.view(b, n, h, d) for t in x.split(h * d, dim=-1))
    w = torch.randn((h * d, 7), device=dev)
    loss = (flash_attention(q, k, v).reshape(b, n, h * d) @ w).square().sum()
    (got,) = torch.autograd.grad(loss, x)
    loss = (flash_attention_plain(q, k, v).reshape(b, n, h * d)
            @ w).square().sum()
    (want,) = torch.autograd.grad(loss, x)
    assert _rel_err(got, want) <= BWD_RTOL


def test_flash_backward_raises_instead_of_falling_back(dev):
    q, k, v = _qkv(1, 64, 64, 2, 24, dev)
    do = torch.randn_like(q)
    lse = torch.zeros((1, 2, 64), device=dev)
    n = (flash_attention_dq.launches, flash_attention_dkv.launches)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_backward(q, k, v, q, lse, do)
    q, k, v = _qkv(1, 64, 64, 2, 40, dev)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_backward(q, k, v, q, lse[:, :, :10],
                                 torch.randn_like(q))
    assert (flash_attention_dq.launches, flash_attention_dkv.launches) == n


def test_ldm_unet_gradients_flash_on_and_off(dev):
    """loss.backward() through the tiny LDM UNet with the gate lowered so
    the kernels run at the level-0 self-attentions, against the plain
    attention path on the same weights: every parameter's gradient agrees,
    and the attn1 projections get a gradient through the kernel."""
    from diffusionmodel_tpu_torch.models.latent_diffusion.runner import ARCHS

    a = {k: v for k, v in ARCHS["tiny"].items() if not k.startswith("ae_")}
    torch.manual_seed(0)
    unet = UNetModel(flash_min_seq=512, **a).to(dev).to(
        memory_format=torch.channels_last)
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((2, 32, 32, 4), generator=g, device=dev)
    t = torch.tensor([10, 900], device=dev)
    cond = torch.randn((2, 77, a["d_cond"]), generator=g, device=dev)
    target = torch.randn((2, 32, 32, 4), generator=g, device=dev)
    grads = []
    for flash in (True, False):
        unet.set_use_flash(flash)
        unet.zero_grad(set_to_none=True)
        n = (flash_attention.launches, flash_attention_dq.launches,
             flash_attention_dkv.launches)
        (unet(x, t, cond) - target).square().mean().backward()
        torch.cuda.synchronize()
        launched = [c.launches - b for c, b in zip(
            (flash_attention, flash_attention_dq, flash_attention_dkv), n)]
        assert launched == ([3, 3, 3] if flash else [0, 0, 0])
        grads.append({k: p.grad for k, p in unet.named_parameters()})
    on, off = grads
    # some gradients are pure rounding noise (a conv bias that a one-channel
    # GroupNorm group removes), so each is held to a share of the largest
    assert all(on[name] is not None for name in off)
    scale = max(g.abs().max().item() for g in off.values())
    for name, want in off.items():
        torch.testing.assert_close(on[name], want, rtol=1e-3,
                                   atol=1e-4 * scale, msg=name)
    flat_on = torch.cat([on[name].flatten() for name in off])
    flat_off = torch.cat([g.flatten() for g in off.values()])
    assert ((flat_on - flat_off).norm() / flat_off.norm()).item() <= 1e-4
    attn1 = unet.input_blocks[1][1].transformer_blocks[0].attn1
    for lin in (attn1.to_q, attn1.to_k, attn1.to_v):
        assert lin.weight.grad.abs().max().item() > 0


def _flagship_small(use_pallas, dev, **over):
    """A narrow ContextUnet v2 (n_feat 32, 64 px) whose SE and CoordAttn
    sites the kernels take, with its config and one uint8 wire batch."""
    from diffusionmodel_tpu_torch.config import preset
    from diffusionmodel_tpu_torch.nn import build_model

    cfg = preset("full", **{"model.n_feat": 32, "model.img_size": 64,
                            "model.use_pallas": use_pallas,
                            "train.accum_steps": 2, "train.batch_size": 2,
                            "train.ema_decay": 0.99, **over})
    torch.manual_seed(0)
    model = build_model(cfg.model, cfg.diffusion.high_thresh, device=dev)
    g = torch.Generator().manual_seed(4)
    batch = {"x": torch.randint(0, 256, (2, 2, 64, 64, 3), generator=g,
                                dtype=torch.uint8),
             "c": torch.randint(0, 5, (2, 2), generator=g),
             "mask": torch.randint(0, 3, (2, 2, 64, 64), generator=g,
                                   dtype=torch.uint8)}
    return cfg, model, batch


def _train_step(cfg, model, dev):
    from diffusionmodel_tpu_torch.diffusion import Schedule
    from diffusionmodel_tpu_torch.train import (
        create_train_state,
        make_train_step,
    )

    dc = cfg.diffusion
    state, opt = create_train_state(model, cfg, 1)
    return state, make_train_step(model, Schedule.create(
        dc.beta1, dc.beta2, dc.n_T, dev), cfg, opt)


def _eval_out(model, dev):
    g = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn((2, 64, 64, 3), generator=g, device=dev)
    with torch.no_grad():
        return model.eval()(x, torch.tensor([0, 3], device=dev),
                            torch.full((2,), 0.3, device=dev),
                            torch.ones(2, device=dev))


def test_train_step_uses_the_twins_with_use_pallas(dev):
    """One train step with ``use_pallas=True`` launches no kernel (train
    mode runs the differentiable twins, as the JAX package does) and gives
    the ``use_pallas=False`` step's loss bit for bit (the same forward);
    the updated weights agree up to cuDNN's weight-gradient sums, which
    are not bit-reproducible: Adam's first step moves each parameter by
    about +-lr, so at most 0.1% of elements (near-zero gradients whose
    sign the rounding decides) may differ by more than 1e-3 lr, none by
    more than 2 lr."""
    results = []
    for use_pallas in (True, False):
        cfg, model, batch = _flagship_small(use_pallas, dev)
        state, step = _train_step(cfg, model, dev)
        n = (se_block.launches, coord_attn.launches)
        loss = step(state, batch, torch.Generator(device=dev).manual_seed(1))
        torch.cuda.synchronize()
        assert (se_block.launches, coord_attn.launches) == n
        results.append((loss.item(), torch.cat(
            [p.detach().flatten() for p in model.parameters()])))
    (l1, p1), (l2, p2) = results
    assert l1 == l2
    lr = cfg.train.lr
    off = (p1 - p2).abs()
    assert (off > 1e-3 * lr).float().mean().item() <= 1e-3
    assert off.max().item() <= 2 * lr


def test_coord_attn_cache_follows_a_train_step_on_the_card(dev):
    """An eval forward through the kernels (CoordAttn caches its packed
    weights), one train step, another eval forward: the last equals a
    fresh kernel model loaded with the new weights, and the plain path on
    them (relative L2 1e-4)."""
    cfg, model, batch = _flagship_small(True, dev)
    before = _eval_out(model, dev)
    state, step = _train_step(cfg, model, dev)
    step(state, batch, torch.Generator(device=dev).manual_seed(2))
    n = (se_block.launches, coord_attn.launches)
    after = _eval_out(model, dev)
    torch.cuda.synchronize()
    assert (se_block.launches - n[0], coord_attn.launches - n[1]) == (5, 4)
    assert not torch.equal(after, before)
    _, fresh, _ = _flagship_small(True, dev)
    fresh.load_state_dict(model.state_dict())
    assert torch.equal(_eval_out(fresh, dev), after)
    _, plain, _ = _flagship_small(False, dev)
    plain.load_state_dict(model.state_dict())
    want = _eval_out(plain, dev)
    assert ((after - want).norm() / want.norm()).item() <= 1e-4


# ------------------------------------------------ metrics and fp32 paths
def test_inception_features_on_the_card_match_the_cpu(dev):
    """The proxy extractor's features of the same four 256 px images on
    the card (fp32, TF32 off, cuDNN) and on the CPU: relative L2 of the
    2048-d features <= 1e-4."""
    from diffusionmodel_tpu_torch.metrics import ImageMetrics

    imgs = torch.rand((4, 256, 256, 3), generator=torch.Generator()
                      .manual_seed(0)).numpy() * 2 - 1
    # the proxy's weights are drawn on the host: the same on both
    got = ImageMetrics(device=dev).extract_features(imgs)
    want = ImageMetrics(device="cpu").extract_features(imgs)
    assert got.shape == want.shape == (4, 2048)
    rel = float(((got - want) ** 2).sum() ** 0.5 / (want ** 2).sum() ** 0.5)
    assert rel <= 1e-4, rel


def _flags_seen(module):
    """A forward pre-hook recording the TF32 flags each forward sees."""
    seen = []

    def pre(mod, args):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))

    return seen, module.register_forward_pre_hook(pre)


def test_serving_and_ldm_entry_points_run_fp32(dev):
    """Under PyTorch's TF32 defaults, ``SamplerService``'s worker and
    ``LdmRunner``'s txt2img / img2img / inpaint run their denoisers with
    TF32 off in cuDNN and cuBLAS; the caller's flags are back after."""
    import numpy as np

    from diffusionmodel_tpu_torch.config import preset
    from diffusionmodel_tpu_torch.diffusion import Schedule
    from diffusionmodel_tpu_torch.models.latent_diffusion.runner import (
        LdmRunner,
    )
    from diffusionmodel_tpu_torch.nn import build_model
    from diffusionmodel_tpu_torch.serving import SamplerService

    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    cudnn.allow_tf32, matmul.allow_tf32 = True, True
    try:
        cfg = preset("full", **{"model.n_feat": 16, "model.img_size": 32,
                                "sample.ddim_steps": 2})
        dc = cfg.diffusion
        model = build_model(cfg.model, dc.high_thresh, device=dev)
        seen, hook = _flags_seen(model)
        with SamplerService(model, cfg, Schedule.create(
                dc.beta1, dc.beta2, dc.n_T, dev), max_batch=2,
                sampler="ddim") as svc:
            svc.generate([0, 1], seed=1)
        hook.remove()
        assert seen and set(seen) == {(False, False)}
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)

        runner = LdmRunner(arch="tiny", steps=2, verbose=False, device=dev)
        seen, hook = _flags_seen(runner.unet)
        runner.txt2img("a crack", h=64, w=64)
        img = np.zeros((1, 64, 64, 3), np.float32)
        runner.img2img(img, "a crack", strength=0.5)
        runner.inpaint(img, "a crack", strength=0.5)
        hook.remove()
        assert len(seen) >= 3 and set(seen) == {(False, False)}
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = False, False


# --- the seventh slice: main-family editing and the side families ----------

@pytest.mark.parametrize("mode", ["img2img", "inpaint"])
def test_edit_launches_the_kernels_each_forward(dev, mode):
    """``sample_cfg_edit`` on a narrow ContextUnet with ``use_pallas``:
    5 SE and 4 CoordAttn launches per DDIM step's forward (k = round(0.75
    * 8) = 6 forwards), finite images, an inpaint's kept pixels equal to
    the source bit for bit, and the kernel path within relative L2 1e-4
    of the plain path on the same weights and noise (chip_smoke's edit
    tolerance: six steps carry one forward's ~1e-6 differences on)."""
    from diffusionmodel_tpu_torch.diffusion import Schedule, sample_cfg_edit

    cfg, model, _ = _flagship_small(True, dev)
    _, plain, _ = _flagship_small(False, dev)
    dc = cfg.diffusion
    sched = Schedule.create(dc.beta1, dc.beta2, dc.n_T, dev)
    g = torch.Generator(device=dev).manual_seed(2)
    x0 = torch.tanh(torch.randn((2, 64, 64, 3), generator=g, device=dev))
    noise = torch.randn((2, 64, 64, 3), generator=g, device=dev)
    mask = None
    if mode == "inpaint":
        mask = torch.zeros((64, 64), device=dev)
        mask[32:] = 1.0
    kw = dict(guide_w=2.0, n_steps=8, strength=0.75, inpaint_mask=mask,
              classes=torch.tensor([1, 3], device=dev), noise=noise)
    n = (se_block.launches, coord_attn.launches)
    got = sample_cfg_edit(model, None, x0, 5, sched, dc, **kw)
    torch.cuda.synchronize()
    assert (se_block.launches - n[0], coord_attn.launches - n[1]) == (30, 24)
    assert got.shape == x0.shape and torch.isfinite(got).all()
    if mask is not None:
        assert torch.equal(got[:, 32:], x0[:, 32:])
    want = sample_cfg_edit(plain, None, x0, 5, sched, dc, **kw)
    rel = ((got - want).norm() / want.norm()).item()
    assert rel <= 1e-4, rel


@pytest.mark.parametrize("name", ["mnist", "custom", "labml"])
def test_side_nets_forward_and_train_step_on_the_card(dev, name):
    """Each side family's net at a narrow width: an eval forward on the
    card equal (1e-4 relative L2) to the same weights' forward on the CPU,
    and one optimizer step with a finite loss that moves the weights."""
    from diffusionmodel_tpu_torch.config import preset
    from diffusionmodel_tpu_torch.nn import build_model

    size = 28 if name == "mnist" else 32
    cfg = preset(name, **{"model.n_feat": 16, "model.img_size": size,
                          "diffusion.n_T": 20, "train.batch_size": 2,
                          "train.accum_steps": 1})
    torch.manual_seed(0)
    model = build_model(cfg.model, cfg.diffusion.high_thresh, device=dev)
    cpu = build_model(cfg.model, cfg.diffusion.high_thresh, device="cpu")
    cpu.load_state_dict(model.state_dict())
    mc = cfg.model
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, size, size, mc.in_ch), generator=g)
    c = torch.tensor([0, mc.n_classes - 1])
    t = (torch.tensor([3.0, 11.0]) if name == "labml"
         else torch.tensor([0.2, 0.7]))
    ctx = torch.ones(2)
    with torch.no_grad():
        got = model.eval()(x.to(dev), c.to(dev), t.to(dev), ctx.to(dev))
        want = cpu.eval()(x, c, t, ctx)
    assert got.shape == (2, size, size, mc.in_ch)
    rel = ((got.cpu() - want).norm() / want.norm()).item()
    assert rel <= 1e-4, rel

    from diffusionmodel_tpu_torch.train import (
        create_train_state,
        make_train_step,
    )

    dc = cfg.diffusion
    if dc.schedule_family == "textbook":
        from diffusionmodel_tpu_torch.models.annotated_ddpm.diffusion import (
            textbook_schedule,
        )

        sched = textbook_schedule(dc.n_T, dc.beta1, dc.beta2, dev)
    else:
        from diffusionmodel_tpu_torch.diffusion import Schedule

        sched = Schedule.create(dc.beta1, dc.beta2, dc.n_T, dev)
    state, opt = create_train_state(model, cfg, 1)
    step = make_train_step(model, sched, cfg, opt)
    before = [p.detach().clone() for p in model.parameters()]
    batch = {"x": x[None], "c": c[None],
             "mask": torch.ones((1, 2, size, size))}
    loss = step(state, batch, torch.Generator(device=dev).manual_seed(2))
    assert torch.isfinite(loss)
    assert any(not torch.equal(a, p) for a, p in zip(before,
                                                     model.parameters()))


def test_labml_service_pinned_request_repeats_on_the_card(dev):
    """A labml (textbook) ``SamplerService`` on the card: a pinned request
    alone and then batched with another gives the same images bit for bit
    (the worker holds cuDNN to its deterministic algorithms), and cuDNN's
    flag is the caller's again after the service closes."""
    import numpy as np

    from diffusionmodel_tpu_torch.config import preset
    from diffusionmodel_tpu_torch.diffusion import Schedule
    from diffusionmodel_tpu_torch.nn import build_model
    from diffusionmodel_tpu_torch.serving import SamplerService

    cfg = preset("labml", **{"model.n_feat": 16, "model.img_size": 32,
                             "diffusion.n_T": 20})
    torch.manual_seed(0)
    model = build_model(cfg.model, cfg.diffusion.high_thresh, device=dev)
    dc = cfg.diffusion
    sched = Schedule.create(dc.beta1, dc.beta2, dc.n_T, dev)
    saved = torch.backends.cudnn.deterministic
    with SamplerService(model, cfg, sched, max_batch=2,
                        service_seed=0) as svc:
        alone = svc.generate([0], guide_w=0.0, seed=3)
        futs = [svc.submit([0], guide_w=4.0),
                svc.submit([0], guide_w=0.0, seed=3)]
        outs = [f.result() for f in futs]
        batches = svc.stats["batches"]
    assert torch.backends.cudnn.deterministic == saved
    assert batches == 2
    assert alone.shape == (1, 32, 32, 3) and np.isfinite(alone).all()
    np.testing.assert_array_equal(outs[1], alone)
