"""The port's SE and CoordAttn kernels on the CPU: their plain twins
against the JAX package's XLA twins (``se_block_xla``, ``coord_attn_xla``)
and modules, the wrappers' dispatch, both kernels' launch plans and their
stages in plain torch, and the module's cache of packed weights. The CUDA kernels themselves are
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
    CHUNK_CHANNELS,
    MAX_SHARED_BYTES,
    CoordAttnWeights,
    coord_attn,
    coord_attn_plain,
    coord_attn_staged,
    launch_plan,
)
from diffusionmodel_tpu_torch.kernels import se_block as se_mod
from diffusionmodel_tpu_torch.kernels.se_block import (
    se_block,
    se_block_plain,
    se_block_staged,
)
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


# The flagship's CoordAttn sites at batch 16 (chip_smoke.CA_SITES), and
# ragged shapes: L off the row tiles, C off the 32-channel chunks, L = 1.
CA_FLAGSHIP = [(16, 128, 128, 192), (16, 64, 64, 384), (16, 32, 32, 768),
               (16, 16, 16, 1536)]
CA_RAGGED = [(3, 20, 20, 96), (2, 9, 9, 80), (1, 1, 1, 64)]
H100_SMS = 132


@pytest.mark.parametrize("shape", CA_FLAGSHIP + CA_RAGGED)
def test_coord_attn_launch_plan(shape):
    b, l, _, c = shape
    r = max(1, c // 16)
    plan = launch_plan(b, l, c, r, "group", gn_groups(r, 8))
    for p in (plan.pool, plan.bottleneck, plan.apply):
        assert min(p.grid) >= 1 and 32 <= p.block <= 1024
        assert p.smem <= MAX_SHARED_BYTES
    # every row and channel is covered by a tile of each pass
    assert plan.n_tiles * plan.pool_rows >= l
    assert plan.pool.grid[0] * CHUNK_CHANNELS >= c
    assert plan.apply.grid[0] * CHUNK_CHANNELS >= c
    assert plan.apply.grid[1] * plan.apply_rows >= l
    assert plan.pool.block // 32 * 4 * 8 >= l  # a lane sums <= 8 columns
    if shape in CA_FLAGSHIP:
        x_bytes = 4 * b * l * l * c
        assert np.prod(plan.pool.grid) >= 4 * H100_SMS
        assert plan.partial_bytes <= 0.1 * x_bytes
        # the two pooled means (2/L of x: 12.5% at L = 16) are the pass's
        # output; what the scratch holds beyond them stays under 10% of x
        means = 2 * 4 * b * l * c
        assert plan.scratch_bytes - means <= 0.1 * x_bytes
    # tiles depend on L, C and R, not on the batch
    one = launch_plan(1, l, c, r, "group", gn_groups(r, 8))
    assert (one.pool_rows, one.apply_rows, one.pool.block) == (
        plan.pool_rows, plan.apply_rows, plan.pool.block)


@pytest.mark.parametrize("shape", SHAPES + [(3, 20, 20, 400)])
@pytest.mark.parametrize("kind", ["group", "affine"])
def test_coord_attn_staged_matches_xla_twin(shape, kind):
    """The kernel's stages and tiles, in plain torch, against the JAX
    package's XLA twin; (3, 20, 20, 400) is ragged in L (16-row tiles), in
    C (32- and 64-channel chunks) and takes two k-slices."""
    c = shape[-1]
    mod, params, stats = _coord_attn(c, "group" if kind == "group"
                                     else "batch", 8)
    groups = gn_groups(c // 16, 8)
    jw = JWeights(params, stats, norm_kind=kind)
    x = np.random.RandomState(9).randn(*shape).astype(np.float32)
    want = np.asarray(coord_attn_xla(jnp.asarray(x), jw, kind, groups))
    with torch.no_grad():
        got = coord_attn_staged(torch.from_numpy(x),
                                CoordAttnWeights.from_module(mod, kind),
                                kind, groups).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_coord_attn_module_caches_packed_weights():
    mod, _, _ = _coord_attn(64, "group", 11)
    mod.use_pallas = True
    x = _nchw(np.random.RandomState(12).randn(2, 8, 8, 64).astype(np.float32))
    g = gn_groups(4, 8)

    def fresh():
        return coord_attn_plain(x.permute(0, 2, 3, 1),
                                CoordAttnWeights.from_module(mod), "group", g)

    with torch.no_grad():
        first = mod._packed()
        assert mod._packed() is first
        mod.conv_h.weight.add_(0.5)
        second = mod._packed()
        assert second is not first
        np.testing.assert_array_equal(_nhwc(mod(x)), fresh().numpy())
        mod.load_state_dict({k: v + 0.1 for k, v in mod.state_dict().items()})
        third = mod._packed()
        assert third is not second and mod._packed() is third
        np.testing.assert_array_equal(_nhwc(mod(x)), fresh().numpy())
    assert "_packed_cache" not in mod.state_dict()
    # with gradients on, or in train mode, every call packs anew
    assert mod._packed() is not mod._packed()
    mod.train()
    mod(x).square().sum().backward()
    assert mod.conv1_h.weight.grad is not None
    assert mod.gamma_h.grad is not None and mod.gamma_h.grad.abs().item() > 0


# The flagship's SE sites at batch 16 (chip_smoke.SE_SITES), and ragged
# shapes: H*W off the tiles, C off the 128-byte rows (C = 8, 20, 200),
# B = 1, 5 and 16.
SE_FLAGSHIP = [(16, 256, 256, 192), (16, 128, 128, 384), (16, 64, 64, 768),
               (16, 32, 32, 1536)]
SE_RAGGED = [(1, 1, 1, 8), (5, 37, 29, 64), (16, 23, 23, 200),
             (5, 130, 130, 192), (1, 5, 7, 8), (16, 3, 3, 1040)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SE_FLAGSHIP + SE_RAGGED)
def test_se_launch_plan(shape, dtype):
    b, h, w, c = shape
    r = max(1, c // 16)
    plan = se_mod.launch_plan(b, h, w, c, r, dtype)
    vec = 16 // dtype.itemsize
    hw = h * w
    # tiles: rows of 1-8 16-byte vectors that tile C; pixels cut into
    # tiles of at most 32 KB; every (pixel, channel) in exactly one tile
    assert plan.row_vectors in (1, 2, 4, 8)
    assert plan.slices * plan.slice_channels == c
    assert plan.tile_pixels * plan.row_vectors * 16 <= se_mod.TILE_BYTES
    assert plan.tiles == plan.slices * plan.pixel_tiles
    cover = np.zeros((hw, c // vec), np.int32)
    for t in range(plan.tiles):
        s, q = divmod(t, plan.pixel_tiles)
        p0 = q * plan.tile_pixels
        assert p0 < hw
        cover[p0:p0 + plan.tile_pixels,
              s * plan.row_vectors:(s + 1) * plan.row_vectors] += 1
    assert (cover == 1).all()
    # parts: consecutive tiles, at most one per block of an H100
    assert plan.parts == -(-plan.tiles // plan.tiles_per_part)
    assert plan.parts <= se_mod.NOMINAL_BLOCKS and plan.grid <= 132
    assert plan.grid == min(b * plan.parts, 132)
    assert plan.streamed == max(0, plan.tiles_per_part - se_mod.SLOTS)
    assert plan.smem == se_mod.smem_bytes(r) <= 227 * 1024
    x_bytes = b * hw * c * dtype.itemsize
    assert plan.bytes_written == x_bytes
    assert plan.bytes_read == x_bytes + 2 * c * r * 4
    assert 0 <= plan.bytes_reread < x_bytes
    # the partition does not depend on the batch (nor on the grid)
    for other in (1, 5, 16):
        o = se_mod.launch_plan(other, h, w, c, r, dtype)
        assert (o.tile_pixels, o.row_vectors, o.tiles_per_part, o.parts,
                o.bytes_reread * b) == (
            plan.tile_pixels, plan.row_vectors, plan.tiles_per_part,
            plan.parts, plan.bytes_reread * other)
    assert se_mod.launch_plan(b, h, w, c, r, dtype, 200).parts == plan.parts
    if shape in SE_FLAGSHIP:
        assert plan.row_vectors == 8  # 128-byte rows
        if dtype == torch.bfloat16 or h < 256:
            assert plan.bytes_reread == 0  # the sample stays on chip
        else:  # fp32 at 256 px: half of each sample is re-read
            assert plan.bytes_reread == x_bytes // 2


def test_se_launch_plan_refusals():
    with pytest.raises(ValueError, match="R="):
        se_mod.launch_plan(2, 8, 8, 64, se_mod.MAX_R + 1)
    with pytest.raises(ValueError, match="C % 8"):
        se_mod.launch_plan(2, 8, 8, 60, 4, torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        se_mod.launch_plan(2, 8, 8, 64, 4, torch.float16)
    with pytest.raises(ValueError, match="resident blocks"):
        se_mod.launch_plan(2, 256, 256, 192, 12, torch.float32, 64)


def _se_numpy(shape, seed):
    b, h, w, c = shape
    r = max(1, c // 16)
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype(np.float32),
            (rng.randn(c, r) / np.sqrt(c)).astype(np.float32),
            (rng.randn(r, c) / np.sqrt(r)).astype(np.float32))


@pytest.mark.parametrize("shape", [(2, 8, 8, 192), (3, 5, 7, 20),
                                   (2, 37, 33, 64), (1, 16, 16, 1040)])
def test_se_staged_matches_xla_twin(shape):
    """The kernel's tiles, parts and order of summation, in plain torch,
    against the JAX package's XLA twin (exact-erf GELU); (2, 37, 33, 64)
    has a ragged last tile, (1, 16, 16, 1040) rows of 2 vectors."""
    x, w1, w2 = _se_numpy(shape, 3)
    want = np.asarray(se_block_xla(jnp.asarray(x), jnp.asarray(w1),
                                   jnp.asarray(w2)))
    got = se_block_staged(*map(torch.from_numpy, (x, w1, w2))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape", [(5, 16, 16, 192), (16, 9, 9, 64)])
def test_se_staged_bf16_matches_twin_and_is_batch_invariant(shape):
    """In bf16, the staged kernel against the bf16 twin within the card
    tests' bounds (relative L2 <= 4e-3, max |diff| <= 2**-7 max |y|), and
    each sample bit-identical alone and inside its batch."""
    x, w1, w2 = _se_numpy(shape, 4)
    tx = torch.from_numpy(x).bfloat16()
    tw1, tw2 = torch.from_numpy(w1), torch.from_numpy(w2)
    got = se_block_staged(tx, tw1, tw2)
    want = se_block_plain(tx, tw1, tw2)
    assert got.dtype == want.dtype == torch.bfloat16
    g, wf = got.float(), want.float()
    assert ((g - wf).norm() / wf.norm()).item() <= 4e-3
    assert (g - wf).abs().max().item() <= 2 ** -7 * wf.abs().max().item()
    for k in (0, shape[0] // 2, shape[0] - 1):
        assert torch.equal(se_block_staged(tx[k:k + 1], tw1, tw2),
                           got[k:k + 1])
