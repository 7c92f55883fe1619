"""The port's fused upsample head (``model.fused_upsample``,
``ops/fused_upconv.py``) against the unfused pair and the JAX package's
``up2_conv3x3_align_corners`` (CPU).

At float32 the fusion is exact algebra: fused and unfused agree to
summation order (relative 1e-5), and the port's op agrees with JAX's at
``ATOL_BLOCK`` 1e-5. At bf16 each of its three stages rounds to bf16, as
JAX's does, so it is held to JAX's bf16 op at a quarter of JAX's own
bf16-vs-fp32 gap."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusionmodel_tpu.ops.fused_upconv import (
    up2_conv3x3_align_corners as jfused,
)
from diffusionmodel_tpu_torch.nn import blocks as tb
from diffusionmodel_tpu_torch.ops.fused_upconv import (
    up2_conv3x3_align_corners,
    up2_conv3x3_align_corners_nchw,
)

torch.set_num_threads(2)

ATOL_BLOCK = 1e-5


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _case(seed, n=2, h=8, w=6, cin=16, cout=8):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, cin).astype(np.float32)
    k = (rng.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(np.float32)
    b = rng.randn(cout).astype(np.float32) * 0.1
    return x, k, b


@pytest.mark.parametrize("shape", [(2, 8, 6, 16, 8), (1, 4, 4, 32, 16)])
def test_fused_op_matches_jax_and_the_unfused_pair_fp32(shape):
    """fp32: the op (JAX layout, HWIO kernel) against JAX's at
    ATOL_BLOCK, and against upsample + conv3x3 in the port to 1e-5
    relative, with and without the bias."""
    x, k, b = _case(0, *shape)
    tx, tk, tbias = map(torch.from_numpy, (x, k, b))
    for bias in (b, None):
        want = np.asarray(jax.jit(jfused)(
            jnp.asarray(x), jnp.asarray(k),
            None if bias is None else jnp.asarray(bias)))
        got = up2_conv3x3_align_corners(tx, tk, None if bias is None
                                        else tbias).numpy()
        assert got.shape == (shape[0], 2 * shape[1], 2 * shape[2], shape[4])
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_BLOCK)
    conv = torch.nn.Conv2d(shape[3], shape[4], 3, padding=1)
    with torch.no_grad():
        conv.weight.copy_(tk.permute(3, 2, 0, 1))
        conv.bias.copy_(tbias)
        xn = tb.channels_last(tx.permute(0, 3, 1, 2))
        pair = conv(tb.UpsampleBilinear2x()(xn))
        fused = up2_conv3x3_align_corners_nchw(xn, conv.weight, conv.bias)
    assert fused.is_contiguous(memory_format=torch.channels_last)
    assert _rel(fused.numpy(), pair.numpy()) <= 1e-5


def test_fused_op_bf16_matches_jax():
    """bf16: the three stages each round to bf16, as JAX's do (no widened
    output); within 0.25 of JAX's own bf16-vs-fp32 gap, output bf16."""
    x, k, b = _case(1)
    opts = {"xla_allow_excess_precision": False}

    def run(dt):
        args = [jnp.asarray(a).astype(dt) for a in (x, k, b)]
        return np.asarray(jax.jit(jfused).lower(*args).compile(
            compiler_options=opts)(*args).astype(jnp.float32))

    j32, j16 = run(jnp.float32), run(jnp.bfloat16)
    g = _rel(j16, j32)
    assert g > 1e-3
    got = up2_conv3x3_align_corners(*(torch.from_numpy(a).bfloat16()
                                      for a in (x, k, b)))
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), j16) <= 0.25 * g


def test_unet_up_fused_shares_the_unfused_state_dict_and_gradients():
    """``UnetUp(fused_upsample=True)`` has the unfused block's
    ``state_dict`` keys and loads its weights unchanged; its output (train
    mode) and every parameter's and the inputs' gradients agree with the
    unfused block's to 1e-5 relative (fp32; the parameters' gradients over
    all of them together: a conv bias before a GroupNorm has a gradient
    of rounding noise alone)."""
    torch.manual_seed(3)
    plain = tb.UnetUp(32, 8).train()
    fused = tb.UnetUp(32, 8, fused_upsample=True).train()
    assert list(fused.state_dict()) == list(plain.state_dict())
    fused.load_state_dict(plain.state_dict())
    rng = np.random.RandomState(4)
    outs = []
    for mod in (plain, fused):
        xa = tb.channels_last(torch.from_numpy(
            rng.randn(2, 16, 6, 6).astype(np.float32))).requires_grad_()
        sk = tb.channels_last(torch.from_numpy(
            rng.randn(2, 16, 6, 6).astype(np.float32))).requires_grad_()
        rng = np.random.RandomState(4)  # the same inputs for both
        y = mod(xa, sk)
        (y * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum() \
            .backward()
        outs.append((y.detach(), xa.grad, sk.grad,
                     {n: p.grad for n, p in mod.named_parameters()}))
    (y0, a0, s0, g0), (y1, a1, s1, g1) = outs
    assert _rel(y1.numpy(), y0.numpy()) <= 1e-5
    assert _rel(a1.numpy(), a0.numpy()) <= 1e-5
    assert _rel(s1.numpy(), s0.numpy()) <= 1e-5
    assert all(torch.isfinite(g).all() for g in g1.values())
    flat = lambda g: np.concatenate([g[n].numpy().ravel()  # noqa: E731
                                     for n in sorted(g)])
    assert _rel(flat(g1), flat(g0)) <= 1e-5
