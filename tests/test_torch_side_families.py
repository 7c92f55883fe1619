"""The side families against the JAX package on the CPU: the MNIST UNet
(``mnist`` preset), the CBAM UNet (``custom``) and the labml U-Net with the
textbook schedule (``labml``), each at n_feat 16 and 16 px (the MNIST fit
at its 28 px).

Weights are the port's PyTorch initialisation (BatchNorm statistics
randomised), carried to the JAX trees by the JAX package's converters
(``convert_mnist_unet``, ``convert_cbam_unet``) or, for the labml U-Net,
which has none, by the port's ``ddpm_unet_rules`` (checked against the
JAX model's own parameter tree). Draws of the textbook process are the
JAX package's ``jax.random`` ones, replayed from its key splits and handed
to the port.

Tolerances (PARITY.md): single blocks atol 1e-5 (the same fp32 arithmetic
summed in another order); whole nets and trajectories rtol 5e-3 / atol
1e-4; the textbook schedule rtol 1e-6 on beta and 1e-5 on abar (fp32
cumprods of other orders); losses rtol 1e-5. The bf16 nets (slow) are
held as ``tests/test_torch_bf16.py`` holds the flagship: no further from
JAX-bf16 than JAX-fp32 is, and at least half that gap from the port's own
float32 forward.
"""

import gzip
import os
import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusionmodel_tpu import checkpoint as jckpt
from diffusionmodel_tpu import diffusion as jd
from diffusionmodel_tpu.compat.torch_convert import (
    convert_cbam_unet,
    convert_mnist_unet,
)
from diffusionmodel_tpu.config import preset as jpreset
from diffusionmodel_tpu.data import mnist as jmnist
from diffusionmodel_tpu.models.annotated_ddpm import diffusion as jtb
from diffusionmodel_tpu.models.annotated_ddpm import unet as junet
from diffusionmodel_tpu.nn import build_model as jbuild_model
from diffusionmodel_tpu.nn import cbam_unet as jcbam
from diffusionmodel_tpu.utils import animation as janim
from diffusionmodel_tpu_torch import diffusion as td
from diffusionmodel_tpu_torch.compat.flax_bridge import flax_trees
from diffusionmodel_tpu_torch.config import preset
from diffusionmodel_tpu_torch.data import mnist as tmnist
from diffusionmodel_tpu_torch.models.annotated_ddpm import diffusion as ttb
from diffusionmodel_tpu_torch.nn import build_model
from diffusionmodel_tpu_torch.nn.blocks import channels_last
from diffusionmodel_tpu_torch.utils import animation as tanim

torch.set_num_threads(2)

RTOL, ATOL = 5e-3, 1e-4
ATOL_BLOCK = 1e-5
S = 16
SIDE = {name: {"model.n_feat": 16, "model.img_size": S, "diffusion.n_T": 8}
        for name in ("mnist", "custom", "labml")}


def _randomize_bn(model, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.randn(buf.shape, generator=g) * 0.1)
            elif name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=g) + 0.5)


def _np_sd(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _jax_trees(name, model):
    """(params, batch_stats) through the JAX package's converters, or the
    port's rules for the labml U-Net (no converter there)."""
    if name == "mnist":
        return convert_mnist_unet(_np_sd(model), norm="batch")
    if name == "custom":
        return convert_cbam_unet(_np_sd(model), norm="group")
    return flax_trees(model)


@pytest.fixture(scope="module")
def nets():
    """name -> (cfg, port model, JAX module, params, batch_stats)."""
    out = {}
    for i, name in enumerate(SIDE):
        cfg = preset(name, **SIDE[name])
        torch.manual_seed(10 + i)
        model = build_model(cfg.model, cfg.diffusion.high_thresh,
                            device="cpu")
        _randomize_bn(model, 20 + i)
        jcfg = jpreset(name, **SIDE[name])
        jm = jbuild_model(jcfg.model, jcfg.diffusion.high_thresh)
        params, stats = _jax_trees(name, model)
        out[name] = (cfg, model, jm, params, stats)
    return out


def _inputs(cfg, seed=3, n=2):
    rng = np.random.RandomState(seed)
    mc = cfg.model
    x = rng.randn(n, S, S, mc.in_ch).astype(np.float32)
    c = (np.arange(n) % mc.n_classes).astype(np.int32)
    if cfg.diffusion.schedule_family == "textbook":
        t = np.array([3.0, 7.0][:n], np.float32)  # raw timesteps
    else:
        t = rng.rand(n).astype(np.float32)
    ctx = (np.arange(n) % 2).astype(np.float32)
    attn = rng.choice([0.5, 1.0, 3.0], (n, S, S)).astype(np.float32)
    return x, c, t, ctx, attn


def _jax_apply(jm, params, stats, *args):
    """The JAX forward in eval mode, jitted (one compile beats the eager
    dispatch of every op)."""
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    fn = jax.jit(lambda v, x, c, t, ctx, attn: jm.apply(
        v, x, c, t, ctx, attn_mask=attn, train=False))
    return np.asarray(fn(variables, *(jnp.asarray(a) for a in args)))


def _port_apply(model, *args):
    with torch.no_grad():
        return model.eval()(*(torch.from_numpy(a) for a in args)) \
            .float().numpy()


@pytest.mark.parametrize("name", list(SIDE))
def test_side_net_forward_matches_jax(nets, name):
    cfg, model, jm, params, stats = nets[name]
    args = _inputs(cfg)
    got = _port_apply(model, *args)
    assert got.shape == (2, S, S, cfg.model.in_ch)
    np.testing.assert_allclose(got, _jax_apply(jm, params, stats, *args),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", list(SIDE))
def test_state_dict_maps_onto_the_jax_tree(nets, name):
    """The port's state_dict, converted, has exactly the JAX model's
    parameter (and BatchNorm statistics) paths and shapes; the factory
    builds the arch with its layout."""
    cfg, model, jm, params, stats = nets[name]
    args = [jnp.asarray(a) for a in _inputs(cfg)]
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        *args[:4], attn_mask=args[4], train=False))
    flat = {jax.tree_util.keystr(p): v.shape for p, v in
            jax.tree_util.tree_leaves_with_path(shapes["params"])}
    ours = {jax.tree_util.keystr(p): np.shape(v) for p, v in
            jax.tree_util.tree_leaves_with_path(params)}
    assert ours == flat
    want_stats = shapes.get("batch_stats", {})
    assert jax.tree.map(np.shape, dict(stats)) == jax.tree.map(
        lambda s: s.shape, dict(want_stats))
    assert model.layout["arch"] == cfg.model.arch


def _nchw(a):
    return channels_last(torch.from_numpy(a).permute(0, 3, 1, 2))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def test_cbam_blocks_match_jax(nets):
    """CBAM (channel then spatial attention) and the down block before
    it, on the first level's weights."""
    _, model, _, params, _ = nets["custom"]
    x = np.random.RandomState(4).randn(2, 8, 8, 16).astype(np.float32)
    want = jcbam.CBAM(16).apply({"params": params["cbam1"]},
                                jnp.asarray(x))
    with torch.no_grad():
        got = _nhwc(model.cbam1(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                               atol=ATOL_BLOCK)
    x = np.random.RandomState(5).randn(2, S, S, 16).astype(np.float32)
    want = jcbam._Down(16, 16).apply({"params": params["down1"]},
                                     jnp.asarray(x))
    with torch.no_grad():
        got = _nhwc(model.down1(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                               atol=ATOL_BLOCK)


def test_labml_blocks_match_jax(nets):
    """TimeEmbedding, a ResidualBlock with its shortcut conv, and an
    AttentionBlock of the labml U-Net, one at a time."""
    _, model, _, params, _ = nets["labml"]
    p = params["DdpmUNet_0"]
    t = np.array([0.0, 5.0, 999.0], np.float32)
    want = junet.TimeEmbedding(64).apply({"params": p["TimeEmbedding_0"]},
                                         jnp.asarray(t))
    with torch.no_grad():
        t_emb = model.time_emb(torch.from_numpy(t))
    np.testing.assert_allclose(t_emb.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL_BLOCK)
    rng = np.random.RandomState(6)
    # down.2 is level 1's first block: 16 -> 32 channels, with a shortcut
    res = model.down[3].res
    assert not isinstance(res.shortcut, torch.nn.Identity)
    x = rng.randn(2, 8, 8, 16).astype(np.float32)
    te = rng.randn(2, 64).astype(np.float32)
    want = junet.ResidualBlock(32).apply(
        {"params": p["ResidualBlock_2"]}, jnp.asarray(x), jnp.asarray(te))
    with torch.no_grad():
        got = _nhwc(res(_nchw(x), torch.from_numpy(te)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                               atol=ATOL_BLOCK)
    attn = model.down[6].attn  # level 2 (4 px), the first attention
    x = rng.randn(2, 4, 4, 32).astype(np.float32)
    want = junet.AttentionBlock().apply({"params": p["AttentionBlock_0"]},
                                        jnp.asarray(x))
    with torch.no_grad():
        got = _nhwc(attn(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                               atol=ATOL_BLOCK)


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float32)
                                - np.asarray(b, np.float32))
                 / np.linalg.norm(np.asarray(b, np.float32)))


@pytest.mark.slow
@pytest.mark.parametrize("name", ["mnist", "custom"])
def test_side_net_bf16_forward(nets, name):
    """bf16 compute (fp32 parameters): the port's bf16 forward is no
    further from JAX-bf16 than JAX-fp32 is (g, which must exceed 1e-3),
    and at least 0.5 g from the port's own float32 forward."""
    cfg, model, _, params, stats = nets[name]
    over = dict(SIDE[name], **{"model.dtype": "bfloat16"})
    jm16 = jbuild_model(jpreset(name, **over).model)
    m16 = build_model(preset(name, **over).model, device="cpu")
    m16.load_state_dict(model.state_dict())
    args = _inputs(cfg, seed=8)
    j16 = jax.jit(lambda *a: jm16.apply(
        {"params": params, **({"batch_stats": stats} if stats else {})},
        *a[:4], attn_mask=a[4], train=False)).lower(
        *[jnp.asarray(a) for a in args]).compile(
        compiler_options={"xla_allow_excess_precision": False})(
        *[jnp.asarray(a) for a in args])
    j32 = _jax_apply(nets[name][2], params, stats, *args)
    g = _rel(j16, j32)
    assert g > 1e-3
    got = _port_apply(m16, *args)
    assert _rel(got, j16) <= g
    assert _rel(got, _port_apply(model, *args)) >= 0.5 * g


# ---------------------------------------------------------- textbook process

@pytest.fixture(scope="module")
def textbook(nets):
    """(port DenoiseDiffusion, JAX DenoiseDiffusion) over the labml net."""
    cfg, model, jm, params, _ = nets["labml"]
    dc = cfg.diffusion

    @jax.jit
    def jeps(x, t):
        n = x.shape[0]
        return jm.apply({"params": params}, x, jnp.zeros((n,), jnp.int32),
                        t.astype(jnp.float32), jnp.zeros((n,)),
                        attn_mask=None, train=False)

    def teps(x, t):
        n = x.shape[0]
        return model.eval()(x, torch.zeros(n, dtype=torch.int64),
                            t.float(), torch.zeros(n))

    return (ttb.DenoiseDiffusion(teps, dc.n_T, dc.beta1, dc.beta2, "cpu"),
            jtb.DenoiseDiffusion(jeps, dc.n_T, dc.beta1, dc.beta2))


def test_textbook_schedule_matches_jax():
    for T in (8, 1000):
        got = ttb.textbook_schedule(T, 1e-4, 0.02, "cpu")
        want = jtb.textbook_schedule(T, 1e-4, 0.02)
        np.testing.assert_allclose(got.beta.numpy(), np.asarray(want.beta),
                                   rtol=1e-6)
        np.testing.assert_allclose(got.alpha_bar.numpy(),
                                   np.asarray(want.alpha_bar), rtol=1e-5)
        np.testing.assert_array_equal(got.sigma2.numpy(), got.beta.numpy())
    np.testing.assert_array_equal(ttb.textbook_chunk_steps(5),
                                  jtb.textbook_chunk_steps(5))


def test_textbook_steps_match_jax(textbook):
    """q_sample, p_x0 and one reverse step with a given z, at t = 0 (no
    noise) and inside the schedule, on the labml net."""
    tdd, jdd = textbook
    rng = np.random.RandomState(9)
    x0 = rng.randn(2, S, S, 3).astype(np.float32)
    eps = rng.randn(2, S, S, 3).astype(np.float32)
    z = rng.randn(2, S, S, 3).astype(np.float32)
    t = np.array([0, 5], np.int32)
    xt = tdd.q_sample(torch.from_numpy(x0), torch.from_numpy(t),
                      torch.from_numpy(eps))
    want = jdd.q_sample(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(eps))
    np.testing.assert_allclose(xt.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(
        tdd.p_x0(xt, torch.from_numpy(t), torch.from_numpy(eps)).numpy(),
        np.asarray(jdd.p_x0(want, jnp.asarray(t), jnp.asarray(eps))),
        rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        got = tdd.p_sample_step(xt, torch.from_numpy(t), z=z)
    want = jdd.p_sample_step(want, jnp.asarray(t), None, z=jnp.asarray(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _jax_step_z(key, steps, shape):
    """The per-step z of the JAX textbook sampler's scan: the x_T key is
    split off first, then one key per step."""
    key, _ = jax.random.split(key)
    out = {}
    for s in steps:
        key, sub = jax.random.split(key)
        out.setdefault(int(s), torch.from_numpy(np.array(
            jax.random.normal(sub, shape, jnp.float32))))
    return out


def test_textbook_sampler_matches_jax_and_padding_is_a_no_op(textbook):
    """The full T-1..0 reverse process with JAX's draws, with x0
    tracking; a chunk padded with -1 gives the unpadded result."""
    tdd, jdd = textbook
    shape = (2, S, S, 3)
    x_init = np.random.RandomState(11).randn(*shape).astype(np.float32)
    key = jax.random.PRNGKey(12)
    steps = np.arange(7, -1, -1, dtype=np.int32)
    want, want_x0 = jdd.sample(key, 2, shape[1:], track_x0=True,
                               steps=jnp.asarray(steps),
                               x_init=jnp.asarray(x_init))
    z = _jax_step_z(key, steps, shape)
    got, got_x0 = tdd.sample(None, 2, shape[1:], track_x0=True,
                             x_init=x_init, noise_fn=z.__getitem__)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got_x0.numpy(), np.asarray(want_x0),
                               rtol=RTOL, atol=ATOL)
    part = tdd.sample(None, 2, shape[1:], steps=[3, 2, 1, 0],
                      x_init=x_init, noise_fn=z.__getitem__)
    padded = tdd.sample(None, 2, shape[1:], steps=[3, 2, 1, 0, -1, -1],
                        x_init=x_init, noise_fn=z.__getitem__)
    torch.testing.assert_close(padded, part, rtol=0, atol=0)


def test_textbook_interpolate_and_loss_match_jax(textbook, nets):
    """``interpolate`` and ``DenoiseDiffusion.loss`` with JAX's draws, and
    ``diffusion.train_loss``'s textbook branch against the JAX one."""
    tdd, jdd = textbook
    rng = np.random.RandomState(13)
    x1, x2 = (rng.randn(2, S, S, 3).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(14)
    want = jdd.interpolate(key, jnp.asarray(x1), jnp.asarray(x2), lam=0.3,
                           t_=4)
    k, k1, k2 = jax.random.split(key, 3)
    n1, n2 = (np.array(jax.random.normal(kk, x1.shape)) for kk in (k1, k2))
    z = {}
    for t in range(4, -1, -1):
        k, sub = jax.random.split(k)
        z[t] = torch.from_numpy(np.array(jax.random.normal(
            sub, x1.shape, jnp.float32)))
    got = tdd.interpolate(x1, x2, lam=0.3, t_=4, noise1=n1, noise2=n2,
                          noise_fn=z.__getitem__)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)

    want = jdd.loss(key, jnp.asarray(x1))
    tkey, nkey = jax.random.split(key)
    t = np.array(jax.random.randint(tkey, (2,), 0, 8))
    eps = np.array(jax.random.normal(nkey, x1.shape, jnp.float32))
    with torch.no_grad():
        got = tdd.loss(torch.from_numpy(x1), t=t, eps=eps)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)

    cfg, model, jm, params, _ = nets["labml"]
    dc = cfg.diffusion
    want = jd.train_loss(
        lambda x, c, tt, ctx, attn, train: jm.apply(
            {"params": params}, x, c, tt, ctx, attn_mask=attn, train=False),
        key, jnp.asarray(x1), jnp.zeros((2,), jnp.int32), None,
        jtb.textbook_schedule(dc.n_T, dc.beta1, dc.beta2), dc, train=False)
    tkey, nkey, _ = jax.random.split(key, 3)
    ts = np.array(jax.random.randint(tkey, (2,), 0, dc.n_T))
    noise = np.array(jax.random.normal(nkey, x1.shape, jnp.float32))
    with torch.no_grad():
        got = td.train_loss(model.eval(), torch.from_numpy(x1),
                            torch.zeros(2, dtype=torch.int64), None,
                            ttb.textbook_schedule(dc.n_T, dc.beta1, dc.beta2,
                                                  "cpu"), dc, ts=ts,
                            noise=noise)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


# ------------------------------------------------------ training and serving

def _dataset(name, cfg):
    from diffusionmodel_tpu_torch.data import (
        CrackDataset,
        MnistDataset,
        SyntheticImageDataset,
    )

    if name == "mnist":  # the fewest images with two of every class
        return MnistDataset(synthetic=True, n_synthetic=32)
    if name == "labml":
        return SyntheticImageDataset(n=8, img_size=S, channels=3)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 255, (8, S, S, 3)).astype(np.uint8)
    boxes = [(40, 60, 200, 300)] * 8
    dc = cfg.diffusion
    return CrackDataset.from_arrays(
        images, boxes, [i % 2 for i in range(8)], ["a", "b"],
        mask_values=(dc.low_weight, dc.mid_weight, dc.high_weight))


@pytest.mark.parametrize("name", list(SIDE))
def test_fit_step_per_preset_checkpoint_reads_in_jax(tmp_path, name):
    """One ``fit`` step of each preset on its own dataset kind (synthetic
    MNIST at 28 px, an in-memory crack set, a synthetic image folder):
    finite losses, and ``ckpt_ep0`` read by the JAX package's loader gives
    a JAX forward equal to the port's trained model's."""
    from diffusionmodel_tpu_torch.trainer import fit

    size = 28 if name == "mnist" else S
    over = dict(SIDE[name], **{
        "model.img_size": size, "model.n_classes": {"mnist": 10,
                                                    "custom": 2,
                                                    "labml": 1}[name],
        "train.batch_size": 24,
        "train.accum_steps": 1, "train.n_epoch": 1,
        # a validation image of every class
        "train.val_split": 0.34 if name == "mnist" else 0.25,
        "train.eval_every": 0, "train.min_save_ep": 0,
        "train.save_dir": str(tmp_path / "run")})
    cfg = preset(name, **over)
    torch.manual_seed(0)
    state = fit(cfg, dataset=_dataset(name, cfg), device="cpu",
                verbose=False)
    assert state.step == 1
    import json

    log = json.load(open(tmp_path / "run" / "metrics" / "metrics_ep0.json"))
    assert np.isfinite(log["train_loss"] + log["val_loss"]).all()
    ck = jckpt.load_checkpoint(str(tmp_path / "run" / "ckpt_ep0"))
    jcfg = jpreset(name, **over)
    jm = jbuild_model(jcfg.model, jcfg.diffusion.high_thresh)
    args = list(_inputs(cfg, seed=15))
    args[0] = np.random.RandomState(16).randn(
        2, size, size, cfg.model.in_ch).astype(np.float32)
    args[4] = np.ones((2, size, size), np.float32)
    want = _jax_apply(jm, jckpt.extract_params(ck, prefer_ema=False),
                      ck.get("batch_stats", {}), *args)
    np.testing.assert_allclose(_port_apply(state.model, *args), want,
                               rtol=RTOL, atol=ATOL)


def test_labml_service_request(nets):
    """The textbook kind of ``SamplerService``: finite images of the right
    shape, the guidance scale ignored, and a pinned request equal alone
    and batched with another (per-slot noise streams)."""
    from diffusionmodel_tpu_torch.serving import SamplerService

    cfg, model, *_ = nets["labml"]
    sched = td.Schedule.create(1e-4, 0.02, cfg.diffusion.n_T, "cpu")
    with SamplerService(model, cfg, sched, max_batch=3,
                        service_seed=0) as svc:
        alone = svc.generate([0], guide_w=0.0, seed=5)
        f1 = svc.submit([0, 0], guide_w=9.0, seed=7)
        f2 = svc.submit([0], guide_w=1.0, seed=5)
        both = f1.result(), f2.result()
    assert alone.shape == (1, S, S, 3) and np.isfinite(alone).all()
    assert both[0].shape == (2, S, S, 3) and np.isfinite(both[0]).all()
    np.testing.assert_array_equal(both[1], alone)


@pytest.mark.parametrize("name, want", [("labml", True), ("mnist", False)])
def test_service_worker_holds_cudnn_deterministic_for_textbook(
        monkeypatch, nets, name, want):
    """The textbook kind's worker runs under ``fp32_compute(deterministic=
    True)`` (a pinned labml request must repeat bit for bit on the card,
    where cuDNN's default choice did not); the main family's keeps cuDNN's
    autotuned choice."""
    import contextlib

    from diffusionmodel_tpu_torch import serving

    seen = []

    @contextlib.contextmanager
    def record(device, autotune=True, deterministic=False):
        seen.append((device.type, autotune, deterministic))
        yield

    monkeypatch.setattr(serving, "fp32_compute", record)
    cfg, model, *_ = nets[name]
    sched = td.Schedule.create(1e-4, 0.02, cfg.diffusion.n_T, "cpu")
    with serving.SamplerService(model, cfg, sched, max_batch=1,
                                service_seed=0):
        pass
    assert seen == [("cpu", True, want)]


# ------------------------------------------------------- data and animation

def _write_idx(path, arr, gz=False):
    arr = np.asarray(arr, np.uint8)
    magic = 0x800 | arr.ndim
    data = struct.pack(">I", magic) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape) + arr.tobytes()
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(data)


@pytest.mark.parametrize("gz", [False, True])
def test_mnist_idx_reader_matches_jax(tmp_path, gz):
    rng = np.random.RandomState(17)
    images = rng.randint(0, 256, (5, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, 5).astype(np.uint8)
    sfx = ".gz" if gz else ""
    _write_idx(tmp_path / f"train-images-idx3-ubyte{sfx}", images, gz)
    _write_idx(tmp_path / f"train-labels-idx1-ubyte{sfx}", labels, gz)
    got = tmnist.load_mnist(str(tmp_path))
    want = jmnist.load_mnist(str(tmp_path))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    ds = tmnist.MnistDataset(str(tmp_path))
    x, c, m = ds.load(3)
    assert x.shape == (28, 28, 1) and c == labels[3] and m.shape == (28, 28)
    with pytest.raises(FileNotFoundError):
        tmnist.load_mnist(str(tmp_path), train=False)
    for a, b in zip(tmnist.synthetic_mnist(6), jmnist.synthetic_mnist(6)):
        np.testing.assert_array_equal(a, b)


def test_return_history_and_gif_match_jax(tmp_path, nets):
    """The ancestral sampler's trajectory (``return_history``) on the MNIST
    net with JAX's draws, and the GIF both packages write from it: the
    same frames (reference_frame_indices) and the same bytes."""
    cfg, model, jm, params, stats = nets["mnist"]
    dc = cfg.diffusion
    x_init = np.random.RandomState(18).randn(2, S, S, 1).astype(np.float32)
    key = jax.random.PRNGKey(19)

    def apply_fn(x, c, t, ctx, attn, train):
        return jm.apply({"params": params, "batch_stats": stats}, x, c, t,
                        ctx, attn_mask=attn, train=False)

    want_x, want_h = jd.sample_cfg(
        apply_fn, key, 2, (S, S, 1), 10, jd.Schedule.create(
            dc.beta1, dc.beta2, dc.n_T), dc, guide_w=2.0,
        return_history=True, x_init=jnp.asarray(x_init))
    k, _ = jax.random.split(key)
    z = {}
    for i in range(dc.n_T, 0, -1):
        k, zk = jax.random.split(k)
        z[i] = torch.from_numpy(np.array(jax.random.normal(
            zk, (2, S, S, 1), jnp.float32)))
    got_x, got_h = td.sample_cfg(
        model, None, 2, (S, S, 1), 10, td.Schedule.create(
            dc.beta1, dc.beta2, dc.n_T, "cpu"), dc, guide_w=2.0,
        x_init=x_init, noise_fn=z.__getitem__, return_history=True)
    assert got_h.shape == (dc.n_T, 2, S, S, 1)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=RTOL,
                               atol=ATOL)
    torch.testing.assert_close(got_h[-1], got_x, rtol=0, atol=0)
    np.testing.assert_array_equal(tanim.reference_frame_indices(700),
                                  janim.reference_frame_indices(700))
    hist = got_h.numpy()
    ours = tanim.save_denoising_gif(got_h, str(tmp_path / "ours.gif"))
    theirs = janim.save_denoising_gif(hist, str(tmp_path / "theirs.gif"))
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    from PIL import Image

    assert Image.open(ours).n_frames == len(
        tanim.reference_frame_indices(dc.n_T))


@pytest.mark.parametrize("name", ["mnist", "labml"])
def test_cli_side_preset_train_then_generate(tmp_path, monkeypatch, name,
                                             capsys):
    """``--mode train --preset mnist|labml`` with no data on disk takes the
    JAX CLI's synthetic fallback (MNIST blobs, a synthetic image set) and
    writes a checkpoint; ``--mode generate`` samples from it (the textbook
    sampler for labml); ``--mode serve`` builds the service on it (the
    HTTP server replaced by one request)."""
    from diffusionmodel_tpu_torch.cli import main

    monkeypatch.chdir(tmp_path)
    size = 28 if name == "mnist" else S
    over = [a for k, v in {"model.n_feat": 8, "model.img_size": size,
                           "diffusion.n_T": 4, "train.eval_every": 0,
                           "train.min_save_ep": 0,
                           "sample.sample_dir": str(tmp_path / "samples"),
                           "sample.ddim_steps": 2}.items()
            for a in ("-o", f"{k}={v}")]
    assert main(["--mode", "train", "--preset", name, "--epochs", "1",
                 "--save_dir", str(tmp_path / "run"), "--device", "cpu",
                 "--data_root", str(tmp_path / "none")] + over) == 0
    assert "synthetic fallback" in capsys.readouterr().out
    assert os.path.isdir(tmp_path / "run" / "ckpt_ep0")
    assert main(["--mode", "generate", "--preset", name, "--ckpt",
                 str(tmp_path / "run" / "ckpt_ep0"), "--samples", "1",
                 "--no_eval", "--device", "cpu", "--guide_scales", "0.0"]
                + over) == 0
    out = os.listdir(tmp_path / "samples")
    made = os.listdir(tmp_path / "samples" / out[0])
    n = 10 if name == "mnist" else 1
    assert len(made) == n + 1  # one image per class and the grid

    from diffusionmodel_tpu_torch import serving

    served = {}

    class OneRequest:
        def __init__(self, service, **kw):
            self.service = service

        def serve_forever(self):
            served["kind"] = self.service.schedule_family
            served["images"] = self.service.generate([0], guide_w=1.0,
                                                      seed=2)

        def server_close(self):
            pass

    monkeypatch.setattr(serving, "make_http_server", OneRequest)
    assert main(["--mode", "serve", "--preset", name, "--ckpt",
                 str(tmp_path / "run" / "ckpt_ep0"), "--max_batch", "1",
                 "--device", "cpu"] + over) == 0
    assert served["images"].shape == (1, size, size, 1 if name == "mnist"
                                      else 3)
    assert served["kind"] == ("textbook" if name == "labml" else "reference")
