"""The port's layers and the full ContextUnet against the JAX package on
the same weights (CPU, float32).

Weights are the port's PyTorch initialisation, carried to the JAX trees by
the JAX package's own converter (``compat/torch_convert.py``); the full
model goes back through the port's bridge, so both directions are used.
Tolerance rtol 5e-3 / atol 1e-4: fp32 convolution stacks summed in other
orders by two frameworks (PARITY.md)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diffusionmodel_tpu.compat.torch_convert import (
    _Mapper,
    convert_context_unet_v2,
)
from diffusionmodel_tpu.nn import ContextUnet as JContextUnet
from diffusionmodel_tpu.nn import blocks as jb
from diffusionmodel_tpu_torch.compat.flax_bridge import state_dict_from_flax
from diffusionmodel_tpu_torch.nn import blocks as tb
from diffusionmodel_tpu_torch.nn.context_unet import ContextUnet

torch.set_num_threads(2)

RTOL, ATOL = 5e-3, 1e-4


def _randomize(model, seed):
    """Non-trivial BatchNorm statistics and CoordAttn scalars."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.randn(buf.shape, generator=g) * 0.1)
            elif name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=g) + 0.5)
        for name, p in model.named_parameters():
            if name.split(".")[-1] in ("gamma_h", "gamma_w", "alpha", "beta"):
                p.copy_(torch.randn(p.shape, generator=g))


def _trees(module, prefix, fill):
    """JAX (params, batch_stats) of a port block, through the JAX
    package's _Mapper; ``fill(mapper)`` names the block's layout."""
    sd = {f"{prefix}.{k}": v.detach().numpy()
          for k, v in module.state_dict().items()}
    m = _Mapper(sd)
    fill(m)
    return m.params[prefix], m.batch_stats.get(prefix, {})


def _apply(jmod, params, stats, *args, **kw):
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    return np.asarray(jmod.apply(variables, *args, **kw))


def _nchw(a):
    return tb.channels_last(torch.from_numpy(a).permute(0, 3, 1, 2))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("norm", ["group", "batch"])
def test_res_conv_block(norm):
    torch.manual_seed(1)
    mod = tb.ResConvBlock(16, 32, is_res=True, norm=norm).eval()
    _randomize(mod, 2)
    params, stats = _trees(mod, "r",
                           lambda m: m.resconv(("r",), "r", norm, True))
    x = np.random.RandomState(3).randn(2, 8, 8, 16).astype(np.float32)
    want = _apply(jb.ResConvBlock(16, 32, is_res=True, norm=norm), params,
                  stats, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = _nhwc(mod(_nchw(x)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("norm", ["group", "batch"])
def test_unet_down_and_up(norm):
    torch.manual_seed(4)
    down = tb.UnetDown(16, 32, norm=norm).eval()
    _randomize(down, 5)
    params, stats = _trees(down, "d",
                           lambda m: m.unet_down_v2(("d",), "d", norm))
    x = np.random.RandomState(6).randn(1, 16, 16, 16).astype(np.float32)
    want = _apply(jb.UnetDown(16, 32, norm=norm), params, stats,
                  jnp.asarray(x), train=False)
    with torch.no_grad():
        got = _nhwc(down(_nchw(x)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)

    up = tb.UnetUp(64, 16, norm=norm).eval()
    _randomize(up, 7)
    params, stats = _trees(up, "u", lambda m: m.unet_up_v2(("u",), "u", norm))
    rng = np.random.RandomState(8)
    xa = rng.randn(1, 8, 8, 32).astype(np.float32)
    skip = rng.randn(1, 8, 8, 32).astype(np.float32)
    want = _apply(jb.UnetUp(64, 16, norm=norm), params, stats,
                  jnp.asarray(xa), jnp.asarray(skip), train=False)
    with torch.no_grad():
        got = _nhwc(up(_nchw(xa), _nchw(skip)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_ops_match_jax():
    """Align-corners bilinear x2 (NHWC) and the torch-semantics adaptive
    pool, including a realign that is not the identity."""
    from diffusionmodel_tpu.ops.pool import adaptive_avg_pool_axis as jpool
    from diffusionmodel_tpu.ops.resize import (
        upsample_bilinear_align_corners as jup,
    )
    from diffusionmodel_tpu_torch.ops.pool import adaptive_avg_pool_axis
    from diffusionmodel_tpu_torch.ops.resize import (
        upsample_bilinear_align_corners,
    )

    x = np.random.RandomState(20).randn(2, 5, 7, 3).astype(np.float32)
    got = upsample_bilinear_align_corners(torch.from_numpy(x), 2).numpy()
    assert got.shape == (2, 10, 14, 3)
    np.testing.assert_allclose(got, np.asarray(jup(jnp.asarray(x), 2)),
                               rtol=0, atol=1e-5)
    for out_size, axis in ((4, 1), (11, 2), (5, 1)):
        got = adaptive_avg_pool_axis(torch.from_numpy(x), out_size, axis)
        want = jpool(jnp.asarray(x), out_size, axis)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)


def test_embed_fc_and_local_enhancer():
    torch.manual_seed(9)
    emb = tb.EmbedFC(3, 32)
    params, _ = _trees(emb, "e", lambda m: m.embed_fc(("e",), "e"))
    v = np.random.RandomState(10).randn(4, 3).astype(np.float32)
    want = _apply(jb.EmbedFC(3, 32), params, {}, jnp.asarray(v))
    with torch.no_grad():
        got = emb(torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)

    le = tb.LocalEnhancer(16, high_thresh=1.2)
    params, _ = _trees(le, "l", lambda m: m.local_enhancer(("l",), "l"))
    rng = np.random.RandomState(11)
    x = rng.randn(2, 8, 8, 16).astype(np.float32)
    mask = (rng.rand(2, 8, 8) * 2).astype(np.float32)
    jle = jb.LocalEnhancer(16, 1.2)
    for m in (mask, None):
        want = _apply(jle, params, {}, jnp.asarray(x),
                      None if m is None else jnp.asarray(m))
        with torch.no_grad():
            got = _nhwc(le(_nchw(x), None if m is None else
                           torch.from_numpy(m)))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(want, x)  # mask None: identity (Q3)


_JAX_OUT = {}


@pytest.mark.parametrize("norm", ["group", "batch"])
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_full_context_unet(norm, use_pallas, with_mask):
    kw = dict(in_ch=3, n_feat=8, n_classes=3, img_size=32, norm=norm)
    torch.manual_seed(12)
    src = ContextUnet(**kw).eval()
    _randomize(src, 13)
    sd = {k: v.detach().numpy() for k, v in src.state_dict().items()}
    params, stats = convert_context_unet_v2(sd, norm=norm)

    rng = np.random.RandomState(14)
    x = rng.randn(2, 32, 32, 3).astype(np.float32)
    c = np.array([0, 2], np.int32)
    t = np.array([0.3, 0.7], np.float32)
    ctx = np.array([1.0, 0.0], np.float32)
    mask = (rng.rand(2, 32, 32) * 2).astype(np.float32) if with_mask else None

    key = (norm, use_pallas, with_mask)
    if key not in _JAX_OUT:
        jm = JContextUnet(**kw, use_pallas=use_pallas)
        _JAX_OUT[key] = _apply(
            jm, params, stats, jnp.asarray(x), jnp.asarray(c),
            jnp.asarray(t), jnp.asarray(ctx),
            attn_mask=None if mask is None else jnp.asarray(mask),
            train=False)
    want = _JAX_OUT[key]

    model = ContextUnet(**kw, use_pallas=use_pallas).eval()
    model.load_state_dict(state_dict_from_flax(params, stats))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(c),
                    torch.from_numpy(t), torch.from_numpy(ctx),
                    None if mask is None else torch.from_numpy(mask))
    assert got.shape == (2, 32, 32, 3) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    if with_mask:  # the spatial mask reaches the LocalEnhancer (Q3)
        base = _JAX_OUT.get((norm, use_pallas, False))
        if base is not None:
            assert np.abs(base - want).max() > 1e-4


def test_scalar_t_broadcast_and_v1():
    """t given as a scalar is broadcast over the batch; v1 is the net
    without LocalEnhancer."""
    torch.manual_seed(15)
    model = ContextUnet(in_ch=3, n_feat=8, n_classes=3, img_size=32,
                        use_local_enhancer=False).eval()
    assert model.local_enhance is None
    x = torch.randn(3, 32, 32, 3)
    c = torch.tensor([0, 1, 2])
    ctx = torch.ones(3)
    with torch.no_grad():
        a = model(x, c, 0.4, ctx)
        b = model(x, c, torch.full((3,), 0.4), ctx)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
