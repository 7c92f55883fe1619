"""The port's SE and CoordAttn kernels on the CPU: their plain twins
against the JAX package's XLA twins (``se_block_xla``, ``coord_attn_xla``)
and modules, and the wrappers' dispatch. The CUDA kernels themselves are
held to these twins on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerance atol 1e-5: the same fp32 arithmetic, summed in another order."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diffusionmodel_tpu.compat.torch_convert import _Mapper
from diffusionmodel_tpu.kernels.coord_attn import CoordAttnWeights as JWeights
from diffusionmodel_tpu.kernels.coord_attn import coord_attn_xla
from diffusionmodel_tpu.kernels.se_block import se_block_xla
from diffusionmodel_tpu.nn.blocks import SEBlock as JSEBlock
from diffusionmodel_tpu.nn.blocks import gn_groups
from diffusionmodel_tpu.nn.coord_attn import CoordAttn as JCoordAttn
from diffusionmodel_tpu_torch.kernels.coord_attn import (
    CoordAttnWeights,
    coord_attn,
    coord_attn_plain,
)
from diffusionmodel_tpu_torch.kernels.se_block import se_block, se_block_plain
from diffusionmodel_tpu_torch.nn.blocks import SEBlock, channels_last
from diffusionmodel_tpu_torch.nn.coord_attn import CoordAttn

torch.set_num_threads(2)

ATOL = 1e-5
SHAPES = [(2, 8, 8, 192), (2, 16, 16, 64)]  # C=192: the flagship's first sites


def _nchw(a):
    return channels_last(torch.from_numpy(a).permute(0, 3, 1, 2))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("shape", SHAPES)
def test_se_plain_twin_matches_xla_twin(shape):
    b, h, w, c = shape
    r = c // 16
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    w1 = (rng.randn(c, r) / np.sqrt(c)).astype(np.float32)
    w2 = (rng.randn(r, c) / np.sqrt(r)).astype(np.float32)
    want = np.asarray(se_block_xla(jnp.asarray(x), jnp.asarray(w1),
                                   jnp.asarray(w2)))
    tx, tw1, tw2 = map(torch.from_numpy, (x, w1, w2))
    got = se_block_plain(tx, tw1, tw2).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # CPU tensors take the twin; the kernel's launch count is untouched
    n = se_block.launches
    np.testing.assert_array_equal(se_block(tx, tw1, tw2).numpy(), got)
    assert se_block.launches == n


@pytest.mark.parametrize("use_pallas", [False, True])
def test_se_module_matches_jax(use_pallas):
    torch.manual_seed(1)
    mod = SEBlock(192, 16, use_pallas=use_pallas).eval()
    sd = {f"b.{k}": v.detach().numpy() for k, v in mod.state_dict().items()}
    m = _Mapper(sd)
    m.dense(("b", "Dense_0"), "b.fc.0")
    m.dense(("b", "Dense_1"), "b.fc.2")
    x = np.random.RandomState(2).randn(2, 8, 8, 192).astype(np.float32)
    want = np.asarray(JSEBlock(192, use_pallas=use_pallas).apply(
        {"params": m.params["b"]}, jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(mod(_nchw(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _coord_attn(c, norm, seed):
    torch.manual_seed(seed)
    mod = CoordAttn(c, 16, norm=norm).eval()
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in (mod.gamma_h, mod.gamma_w, mod.alpha, mod.beta):
            p.copy_(torch.randn(1, generator=g))
        if norm == "batch":
            for bn in (mod.bn1_h, mod.bn1_w):
                bn.running_mean.copy_(torch.randn(bn.num_features,
                                                  generator=g) * 0.1)
                bn.running_var.copy_(torch.rand(bn.num_features,
                                                generator=g) + 0.5)
        else:
            for gn in (mod.bn1_h, mod.bn1_w):
                gn.weight.copy_(1 + 0.1 * torch.randn(gn.num_channels,
                                                      generator=g))
                gn.bias.copy_(0.1 * torch.randn(gn.num_channels, generator=g))
    sd = {f"ca.{k}": v.detach().numpy() for k, v in mod.state_dict().items()}
    m = _Mapper(sd)
    m.coord_attn(("ca",), "ca", norm)
    return mod, m.params["ca"], m.batch_stats.get("ca", {})


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", ["group", "affine"])
def test_coord_attn_plain_twin_matches_xla_twin(shape, kind):
    c = shape[-1]
    norm = "group" if kind == "group" else "batch"
    mod, params, stats = _coord_attn(c, norm, 3)
    groups = gn_groups(c // 16, 8)
    jw = JWeights(params, stats, norm_kind=kind)
    tw = CoordAttnWeights.from_module(mod, kind)
    for f in ("w1h", "w1w", "nh", "nw", "wmix", "wout", "bout"):
        np.testing.assert_allclose(getattr(tw, f).detach().numpy(),
                                   np.asarray(getattr(jw, f)), rtol=1e-6,
                                   atol=1e-7, err_msg=f)
    np.testing.assert_allclose(tw.scal.detach().numpy(),
                               np.asarray(jw.scal)[0, :4], rtol=1e-6)

    x = np.random.RandomState(4).randn(*shape).astype(np.float32)
    want = np.asarray(coord_attn_xla(jnp.asarray(x), jw, kind, groups))
    tx = torch.from_numpy(x)
    with torch.no_grad():
        got = coord_attn_plain(tx, tw, kind, groups).numpy()
        # the twin also takes the JAX package's packing as it is
        got_j = coord_attn_plain(tx, CoordAttnWeights(**{
            f: torch.from_numpy(np.array(getattr(jw, f)))
            for f in ("w1h", "w1w", "nh", "nw", "wmix", "wout", "bout",
                      "scal")}), kind, groups).numpy()
        n = coord_attn.launches
        via_wrapper = coord_attn(tx, tw, kind, groups).numpy()
    assert coord_attn.launches == n
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_j, want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(via_wrapper, got)


@pytest.mark.parametrize("norm", ["group", "batch"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_coord_attn_module_matches_jax(norm, use_pallas):
    mod, params, stats = _coord_attn(64, norm, 5)
    mod.use_pallas = use_pallas
    x = np.random.RandomState(6).randn(2, 16, 16, 64).astype(np.float32)
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    want = np.asarray(JCoordAttn(64, 16, norm=norm, use_pallas=use_pallas)
                      .apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = _nhwc(mod(_nchw(x)))
        mod.train()  # train mode: the plain path (fused: its twin)
        got_train = _nhwc(mod(_nchw(x))) if norm == "group" else got
        mod.eval()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_train, want, rtol=0, atol=ATOL)


def test_wrappers_refuse_other_devices():
    x = torch.empty((1, 8, 8, 64), device="meta")
    w1 = torch.empty((64, 4), device="meta")
    w2 = torch.empty((4, 64), device="meta")
    with pytest.raises(ValueError, match="device"):
        se_block(x, w1, w2)
    mod, _, _ = _coord_attn(64, "group", 7)
    with pytest.raises(ValueError, match="device"):
        coord_attn(x, CoordAttnWeights.from_module(mod), "group", 4)
