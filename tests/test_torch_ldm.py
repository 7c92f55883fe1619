"""The port's latent-diffusion slice against the JAX package on the CPU.

Weights are drawn by the port (torch seed), carried to JAX by the JAX
package's own SD converter (``compat/sd_convert``), and both packages get
the same numpy inputs and the same noise: x_T, the per-step draws, the
VAE posterior draw and the q_sample / inpainting noise are the JAX
package's own ``jax.random`` draws, reproduced here from its key splits
and handed to the port.

Tolerances:
- flash twin and its logsumexp against the Pallas kernel in interpret
  mode, and single blocks: atol 1e-5 (the same fp32 arithmetic summed in
  another order);
- the whole tiny UNet, the VAE and sampler / pipeline trajectories: rtol
  5e-3 / atol 5e-4 (PARITY.md's full-model tolerance, the absolute term
  widened for a few steps of accumulation);
- the LDM schedule: rtol 1e-5 (both fp32; the cumprods of 1000 factors
  are taken in other orders and differ by up to 1.4e-6);
- ``_hash_embedding`` and the DDIM / DPM++ tau tables: bit for bit.
"""

import ast
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusionmodel_tpu.compat.sd_convert import (
    convert_sd_autoencoder,
    convert_sd_unet,
    fabricate_sd_state_dict,
    load_sd_checkpoint as jax_load_sd_checkpoint,
)
from diffusionmodel_tpu.kernels.flash_attn import (
    _flash_forward,
    _pad_to,
    flash_attention as jax_flash_attention,
)
from diffusionmodel_tpu.models.latent_diffusion import autoencoder as jae
from diffusionmodel_tpu.models.latent_diffusion import pipelines as jpipe
from diffusionmodel_tpu.models.latent_diffusion import samplers as jsamp
from diffusionmodel_tpu.models.latent_diffusion import unet as junet
from diffusionmodel_tpu.models.latent_diffusion.latent_diffusion import (
    LatentDiffusion as JLatentDiffusion,
    ldm_schedule as jax_ldm_schedule,
)
from diffusionmodel_tpu.models.latent_diffusion.runner import (
    ARCHS as JARCHS,
    _hash_embedding as jax_hash_embedding,
)
from diffusionmodel_tpu_torch.compat.flax_bridge import (
    autoencoder_state_dict_from_flax,
    ldm_unet_state_dict_from_flax,
)
from diffusionmodel_tpu_torch.compat.sd_checkpoint import load_sd_checkpoint
from diffusionmodel_tpu_torch.kernels.flash_attn import (
    flash_attention,
    flash_attention_plain,
)
from diffusionmodel_tpu_torch.models.latent_diffusion import pipelines as tpipe
from diffusionmodel_tpu_torch.models.latent_diffusion import samplers as tsamp
from diffusionmodel_tpu_torch.models.latent_diffusion.autoencoder import (
    Autoencoder,
)
from diffusionmodel_tpu_torch.models.latent_diffusion.latent_diffusion import (
    LatentDiffusion,
    ldm_schedule,
)
from diffusionmodel_tpu_torch.models.latent_diffusion.runner import (
    ARCHS,
    LdmRunner,
    _hash_embedding,
)
from diffusionmodel_tpu_torch.models.latent_diffusion.unet import (
    UNetModel,
    sinusoidal_time_emb,
    time_frequencies,
)
from diffusionmodel_tpu_torch.models.latent_diffusion.util import set_seed
from diffusionmodel_tpu_torch.nn.blocks import GroupNorm, channels_last

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
ATOL_BLOCK = 1e-5
RTOL, ATOL = 5e-3, 5e-4
T_SCHED = 20  # a short LDM schedule keeps the trajectories quick
UNET_KW = {k: v for k, v in ARCHS["tiny"].items() if not k.startswith("ae_")}
UNET_LAYOUT = dict(channel_multipliers=UNET_KW["channel_multipliers"],
                   attention_levels=UNET_KW["attention_levels"],
                   n_res_blocks=UNET_KW["n_res_blocks"])
AE_MULTS = ARCHS["tiny"]["ae_mults"]
AE_CH = ARCHS["tiny"]["ae_channels"]
D_COND = UNET_KW["d_cond"]
UP, AP = "model.diffusion_model.", "first_stage_model."


def _np(sd):
    return {k: v.detach().numpy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def tiny():
    """Port tiny UNet (gate lowered to 32 tokens) and VAE, and the JAX
    parameter trees made from their state dicts by the JAX converter."""
    torch.manual_seed(0)
    unet = UNetModel(flash_min_seq=32, **UNET_KW).to(
        memory_format=torch.channels_last).eval()
    ae = Autoencoder(AE_CH, AE_MULTS).to(
        memory_format=torch.channels_last).eval()
    # non-trivial norm affines, so a swapped scale/bias would show
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in list(unet.named_parameters()) + list(
                ae.named_parameters()):
            if "norm" in name or "in_layers.0" in name or \
                    "out_layers.0" in name or name.startswith("out.0"):
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    uparams, miss_u = convert_sd_unet(
        {UP + k: v for k, v in _np(unet.state_dict()).items()},
        **UNET_LAYOUT)
    aparams, miss_a = convert_sd_autoencoder(
        {AP + k: v for k, v in _np(ae.state_dict()).items()},
        ch_mults=AE_MULTS)
    assert not miss_u and not miss_a
    return unet, ae, uparams, aparams


def _jax_unet(**kw):
    return junet.UNetModel(flash_min_seq=32, **{**UNET_KW, **kw})


def _jax_ae():
    return jae.Autoencoder(channels=AE_CH, ch_mults=AE_MULTS)


# --- flash attention ---------------------------------------------------------

def _dump_lse_mismatch(tmp_path, q, k, v, lse, want_lse, lse_again,
                       pallas_lse):
    """On an lse mismatch only: save the inputs and both sides' lse, with
    a second evaluation of each, and say which side moved from the other's
    rerun (the assertion message reaches the junit XML when the dump
    directory is gone)."""
    again = pallas_lse()
    path = tmp_path / "lse_mismatch.npz"
    np.savez(path, q=q, k=k, v=v, port_lse=lse, pallas_lse=want_lse,
             pallas_lse_again=again, port_lse_again=lse_again)

    def gap(a, b):
        return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))

    return (f"lse mismatch dumped to {path}: pallas vs its rerun "
            f"{gap(want_lse, again):.3g}, port vs its rerun "
            f"{gap(lse, lse_again):.3g}, port vs pallas rerun "
            f"{gap(lse, again):.3g}, jax_default_matmul_precision="
            f"{jax.config.jax_default_matmul_precision}, "
            f"torch threads {torch.get_num_threads()}")


@pytest.mark.parametrize("d", [16, 40])
def test_flash_twin_matches_pallas_interpret(d, tmp_path):
    rng = np.random.RandomState(d)
    b, n, m, h = 2, 200, 300, 2
    q = rng.randn(b, n, h, d).astype(np.float32)
    k = rng.randn(b, m, h, d).astype(np.float32)
    v = rng.randn(b, m, h, d).astype(np.float32)
    want = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128,
        block_k=128, interpret=True))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got, lse = flash_attention_plain(tq, tk, tv, want_lse=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL_BLOCK)
    # the forward's logsumexp, from the Pallas forward itself
    fold = [jnp.asarray(a).transpose(0, 2, 1, 3).reshape(b * h, -1, d)
            for a in (q, k, v)]
    qf = _pad_to(fold[0], 1, 128)
    kf, vf = (_pad_to(a, 1, 128) for a in fold[1:])

    def pallas_lse():
        return _flash_forward(qf, kf, vf, 128, 128, m, interpret=True,
                              want_lse=True)

    out_f, lse_f = pallas_lse()
    want_lse = np.asarray(lse_f)[:, :n, 0].reshape(b, h, n)
    if not np.allclose(lse.numpy(), want_lse, rtol=0, atol=ATOL_BLOCK):
        lse_again = flash_attention_plain(tq, tk, tv, want_lse=True)[1]
        pytest.fail(_dump_lse_mismatch(
            tmp_path, q, k, v, lse.numpy(), want_lse, lse_again.numpy(),
            lambda: np.asarray(pallas_lse()[1])[:, :n, 0].reshape(b, h, n)))
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=0,
                               atol=ATOL_BLOCK)
    np.testing.assert_allclose(
        np.asarray(out_f)[:, :n].reshape(b, h, n, d).transpose(0, 2, 1, 3),
        want, rtol=0, atol=ATOL_BLOCK)
    # a CPU tensor takes the twin through the wrapper; no launch counted
    launches = flash_attention.launches
    np.testing.assert_array_equal(flash_attention(tq, tk, tv).numpy(),
                                  got.numpy())
    assert flash_attention.launches == launches


# --- blocks ------------------------------------------------------------------

def _nchw(a):
    return channels_last(torch.from_numpy(a).permute(0, 3, 1, 2))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def test_unet_blocks_match_jax(tiny):
    """ResBlock (with its 1×1 skip) and SpatialTransformer, one at a time,
    on the weights of the tiny UNet's blocks."""
    unet, _, uparams, _ = tiny
    rng = np.random.RandomState(3)
    t_emb = rng.randn(2, 128).astype(np.float32)
    x = rng.randn(2, 4, 4, 32).astype(np.float32)  # level 1 input, 32 ch
    res = unet.input_blocks[3][0]  # down_1_0_res: 32 -> 64
    assert not isinstance(res.skip_connection, torch.nn.Identity)
    want = junet.ResBlock(64).apply({"params": uparams["down_1_0_res"]},
                                    jnp.asarray(x), jnp.asarray(t_emb))
    with torch.no_grad():
        got = _nhwc(res(_nchw(x), torch.from_numpy(t_emb)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                               atol=ATOL_BLOCK)

    x = rng.randn(2, 8, 8, 32).astype(np.float32)
    cond = rng.randn(2, 77, D_COND).astype(np.float32)
    st = unet.input_blocks[1][1]  # down_0_0_attn, 64 tokens: gate taken
    want = junet.SpatialTransformer(32, 2, use_flash=True, flash_min_seq=32
                                    ).apply(
        {"params": uparams["down_0_0_attn"]}, jnp.asarray(x),
        jnp.asarray(cond))
    with torch.no_grad():
        got = _nhwc(st(_nchw(x), torch.from_numpy(cond)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                               atol=ATOL_BLOCK)


def test_vae_blocks_match_jax(tiny):
    _, ae, _, aparams = tiny
    rng = np.random.RandomState(4)
    x = rng.randn(2, 8, 8, 32).astype(np.float32)
    blk = ae.encoder.down[2].block[0]  # 32 -> 64 with nin_shortcut
    want = jae.ResnetBlock(64).apply(
        {"params": aparams["encoder"]["down_2_block_0"]}, jnp.asarray(x))
    with torch.no_grad():
        got = _nhwc(blk(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                               atol=ATOL_BLOCK)
    x = rng.randn(2, 8, 8, 64).astype(np.float32)
    want = jae.AttnBlock().apply(
        {"params": aparams["encoder"]["mid_attn"]}, jnp.asarray(x))
    with torch.no_grad():
        got = _nhwc(ae.encoder.mid.attn_1(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                               atol=ATOL_BLOCK)


def test_time_embedding_and_schedule_match_jax():
    """The sinusoidal embedding, in three checks, then the schedule.

    Both packages form the same float32 exponent -log(P) * k / half and
    take exp of it; torch's and XLA's exp land within 1 ulp of the float64
    exp of that exponent each, but not always on the same float32 (they
    differ in some of the 32), so each is held to float64 within 1 ulp.
    Given one float32 angle table, torch's and XLA's sin and cos agree
    within 1e-6. The whole embedding then differs by the angle's
    difference, t * (f_torch - f_jax), of at most t * 2 ulp(f), since
    |d sin| <= |d angle|: at t = 999 up to ~1.2e-4, the bound per row is
    1e-5 + t * 2 ulp(f)."""
    half, period = 32, 10000
    t = np.array([0, 1, 17, 999])
    # the exponent as both packages form it in float32 (the JAX package's
    # sinusoidal_time_emb, unet.py:32-33, whose line this repeats)
    arg = np.asarray(-np.log(period) * jnp.arange(half, dtype=jnp.float32)
                     / half)
    exact = np.exp(arg.astype(np.float64))
    ulp = np.spacing(exact.astype(np.float32)).astype(np.float64)
    mine = time_frequencies(2 * half, period).numpy().astype(np.float64)
    theirs = np.asarray(jnp.exp(jnp.asarray(arg))).astype(np.float64)
    assert np.all(np.abs(mine - exact) <= ulp), np.abs(mine - exact) / ulp
    assert np.all(np.abs(theirs - exact) <= ulp), \
        np.abs(theirs - exact) / ulp
    ang = (t[:, None].astype(np.float32) * exact.astype(np.float32))
    for tf, jf in ((torch.sin, jnp.sin), (torch.cos, jnp.cos)):
        np.testing.assert_allclose(tf(torch.from_numpy(ang)).numpy(),
                                   np.asarray(jf(jnp.asarray(ang))),
                                   rtol=0, atol=1e-6)
    got = sinusoidal_time_emb(torch.from_numpy(t), 2 * half).numpy()
    want = np.asarray(junet.sinusoidal_time_emb(jnp.asarray(t), 2 * half))
    bound = ATOL_BLOCK + t[:, None] * 2 * np.concatenate([ulp, ulp])
    assert np.all(np.abs(got - want) <= bound), np.max(
        np.abs(got - want) / bound)
    for n in (20, 1000):
        mine, ref = ldm_schedule(n, device="cpu"), jax_ldm_schedule(n)
        for a, b in zip(mine, ref):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)


# --- whole models ------------------------------------------------------------

def test_tiny_unet_matches_jax(tiny):
    """64 px image -> 8×8 latent: 64 tokens >= flash_min_seq 32, so both
    packages take the flash gate (the port's twin, JAX's attention_xla)."""
    unet, _, uparams, _ = tiny
    rng = np.random.RandomState(5)
    x = rng.randn(3, 8, 8, 4).astype(np.float32)
    t = np.array([3, 500, 999])
    cond = rng.randn(3, 77, D_COND).astype(np.float32)
    want = jax.jit(_jax_unet().apply)({"params": uparams}, jnp.asarray(x),
                                      jnp.asarray(t), jnp.asarray(cond))
    with torch.no_grad():
        got = unet(torch.from_numpy(x), torch.from_numpy(t),
                   torch.from_numpy(cond)).numpy()
    assert got.shape == (3, 8, 8, 4)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_tiny_vae_matches_jax(tiny):
    _, ae, _, aparams = tiny
    rng = np.random.RandomState(6)
    img = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    z = rng.randn(2, 8, 8, 4).astype(np.float32)
    jm = _jax_ae()
    dist = jm.apply({"params": aparams}, jnp.asarray(img), method=jm.encode)
    dec = jm.apply({"params": aparams}, jnp.asarray(z), method=jm.decode)
    with torch.no_grad():
        mine = ae.encode(torch.from_numpy(img))
        got_dec = ae.decode(torch.from_numpy(z)).numpy()
    for a, b in ((mine.mean, dist.mean), (mine.logvar, dist.logvar),
                 (mine.std, dist.std)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(got_dec, np.asarray(dec), rtol=RTOL, atol=ATOL)


# --- samplers and pipelines --------------------------------------------------

@pytest.fixture(scope="module")
def ldms(tiny):
    unet, ae, uparams, aparams = tiny
    ju, ja = _jax_unet(), _jax_ae()
    jmodel = JLatentDiffusion(
        lambda x, t, c: ju.apply({"params": uparams}, x, t, c),
        lambda img: ja.apply({"params": aparams}, img, method=ja.encode),
        lambda z: ja.apply({"params": aparams}, z, method=ja.decode),
        n_steps=T_SCHED)
    tmodel = LatentDiffusion(unet, ae.encode, ae.decode, n_steps=T_SCHED,
                             device="cpu")
    return jmodel, tmodel


def _normals(key, shape, n):
    """The per-step draws of a JAX sampler's scan that starts from ``key``
    and splits ``key, sub = split(key)`` once a step."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.array(jax.random.normal(sub, shape, jnp.float32)))
    return out


def _conds(seed, b=2):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, 77, D_COND).astype(np.float32),
            rng.randn(b, 77, D_COND).astype(np.float32))


def test_time_step_tables_bit_exact(ldms):
    jmodel, tmodel = ldms
    for n, disc in ((5, "uniform"), (7, "uniform"), (5, "quad"),
                    (20, "uniform")):
        jd, td = (jsamp.DDIMSampler(jmodel, n, 0.5, disc),
                  tsamp.DDIMSampler(tmodel, n, 0.5, disc))
        np.testing.assert_array_equal(td.time_steps, jd.time_steps)
        jp, tp = (jsamp.DPMPPSampler(jmodel, n, disc),
                  tsamp.DPMPPSampler(tmodel, n, disc))
        np.testing.assert_array_equal(tp.time_steps, jp.time_steps)
    # the 512 px edit path: strength 0.75 of DDIM-50 runs 37 steps
    ddim = tsamp.DDIMSampler(LatentDiffusion(None, device="cpu"), 50)
    assert int(0.75 * ddim.n_steps) == 37


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_ddim_trajectory_matches_jax(ldms, eta):
    jmodel, tmodel = ldms
    cond, uncond = _conds(7)
    shape = (2, 8, 8, 4)
    x_t = np.random.RandomState(8).randn(*shape).astype(np.float32)
    key = jax.random.PRNGKey(9)
    js = jsamp.DDIMSampler(jmodel, n_steps=5, ddim_eta=eta)
    want = js.sample(key, shape, jnp.asarray(cond), x_last=jnp.asarray(x_t),
                     uncond_scale=3.0, uncond_cond=jnp.asarray(uncond))
    steps = _normals(jax.random.split(key)[0], shape, js.n_steps)
    by_index = dict(zip(range(js.n_steps - 1, -1, -1), steps))
    ts = tsamp.DDIMSampler(tmodel, n_steps=5, ddim_eta=eta)
    got = ts.sample(shape, torch.from_numpy(cond), x_last=x_t,
                    uncond_scale=3.0, uncond_cond=torch.from_numpy(uncond),
                    noise_fn=by_index.__getitem__)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_dpmpp_trajectory_matches_jax(ldms):
    jmodel, tmodel = ldms
    cond, uncond = _conds(10)
    shape = (2, 8, 8, 4)
    x_t = np.random.RandomState(11).randn(*shape).astype(np.float32)
    want = jsamp.DPMPPSampler(jmodel, n_steps=5).sample(
        jax.random.PRNGKey(0), shape, jnp.asarray(cond),
        x_last=jnp.asarray(x_t), uncond_scale=7.5,
        uncond_cond=jnp.asarray(uncond))
    got = tsamp.DPMPPSampler(tmodel, n_steps=5).sample(
        shape, torch.from_numpy(cond), x_last=x_t, uncond_scale=7.5,
        uncond_cond=torch.from_numpy(uncond))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_ddpm_trajectory_matches_jax(ldms):
    """Txt2Img with DDPM over the last 8 of 20 steps (``skip_steps`` 12),
    decoded: the JAX x_T and per-step draws, handed to the port."""
    jmodel, tmodel = ldms
    cond, uncond = _conds(12, b=1)
    key = jax.random.PRNGKey(13)
    skip = 12
    jpipe_ddpm = jpipe.Txt2Img(jmodel, sampler="ddpm")
    # Txt2Img forwards no skip_steps: run the JAX sampler as the pipeline
    # would, then decode
    _, skey = jax.random.split(key)
    k2, xkey = jax.random.split(skey)
    shape = (1, 8, 8, 4)
    x_t = np.array(jax.random.normal(xkey, shape, jnp.float32))
    want = jmodel.autoencoder_decode(jpipe_ddpm.sampler.sample(
        skey, shape, jnp.asarray(cond), uncond_scale=2.0,
        uncond_cond=jnp.asarray(uncond), skip_steps=skip))
    order = range(T_SCHED - 1 - skip, -1, -1)
    by_t = dict(zip(order, _normals(k2, shape, len(order))))
    got = tpipe.Txt2Img(tmodel, sampler="ddpm")(
        cond, batch_size=1, h=64, w=64, uncond_scale=2.0, uncond=uncond,
        x_last=x_t, noise_fn=by_t.__getitem__, skip_steps=skip)
    assert got.shape == (1, 64, 64, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _img(seed):
    return np.random.RandomState(seed).uniform(
        -1, 1, (2, 64, 64, 3)).astype(np.float32)


def test_txt2img_matches_jax(ldms):
    jmodel, tmodel = ldms
    cond, uncond = _conds(14)
    key = jax.random.PRNGKey(15)
    want = jpipe.Txt2Img(jmodel, n_steps=4)(
        key, cond=jnp.asarray(cond), batch_size=2, h=64, w=64,
        uncond_scale=7.5, uncond=jnp.asarray(uncond))
    _, skey = jax.random.split(key)
    x_t = jax.random.normal(jax.random.split(skey)[1], (2, 8, 8, 4))
    got = tpipe.Txt2Img(tmodel, n_steps=4)(
        cond, batch_size=2, h=64, w=64, uncond_scale=7.5, uncond=uncond,
        x_last=np.array(x_t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_img2img_matches_jax(ldms):
    jmodel, tmodel = ldms
    cond, uncond = _conds(16)
    img = _img(17)
    key = jax.random.PRNGKey(18)
    want = jpipe.Img2Img(jmodel, n_steps=8)(
        key, jnp.asarray(img), cond=jnp.asarray(cond), strength=0.75,
        uncond_scale=5.0, uncond=jnp.asarray(uncond))
    _, ekey, qkey, _ = jax.random.split(key, 4)
    zshape = (2, 8, 8, 4)
    got = tpipe.Img2Img(tmodel, n_steps=8)(
        img, cond, strength=0.75, uncond_scale=5.0, uncond=uncond,
        encode_noise=np.array(jax.random.normal(ekey, zshape)),
        q_noise=np.array(jax.random.normal(qkey, zshape)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_inpaint_matches_jax(ldms):
    """The default keep-mask (bottom half of the latent) and the original
    re-noised with the same orig_noise at every step."""
    jmodel, tmodel = ldms
    cond, uncond = _conds(19)
    img = _img(20)
    key = jax.random.PRNGKey(21)
    want = jpipe.InPaint(jmodel, n_steps=8)(
        key, jnp.asarray(img), cond=jnp.asarray(cond), strength=0.5,
        uncond_scale=5.0, uncond=jnp.asarray(uncond))
    _, ekey, nkey, qkey, _ = jax.random.split(key, 5)
    zshape = (2, 8, 8, 4)
    got = tpipe.InPaint(tmodel, n_steps=8)(
        img, cond, strength=0.5, uncond_scale=5.0, uncond=uncond,
        encode_noise=np.array(jax.random.normal(ekey, zshape)),
        orig_noise=np.array(jax.random.normal(nkey, zshape)),
        q_noise=np.array(jax.random.normal(qkey, zshape)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_hash_embedding_bit_exact():
    prompts = ["hello", "", "a painting of a virus monster playing guitar"]
    for d in (16, 768):
        np.testing.assert_array_equal(_hash_embedding(prompts, d),
                                      jax_hash_embedding(prompts, d))
    # the JAX package's archs, as it has them; the SDXL archs are the port's
    assert {k: v for k, v in ARCHS.items() if k in JARCHS} == JARCHS
    assert set(ARCHS) - set(JARCHS) == {"sdxl", "sdxl-tiny"}


# --- weights: the SD-name bridge and the checkpoint loader -------------------

def test_sd_bridge_round_trip_bit_exact(tiny):
    """port state_dict (SD names) -> JAX ``convert_sd_unet`` /
    ``convert_sd_autoencoder`` -> the port's bridge: the identity, bit for
    bit, and a strict load takes it."""
    unet, ae, uparams, aparams = tiny
    for model, back in (
            (unet, ldm_unet_state_dict_from_flax(uparams, **UNET_LAYOUT)),
            (ae, autoencoder_state_dict_from_flax(aparams, AE_MULTS))):
        sd = model.state_dict()
        assert set(back) == set(sd)
        for k, v in sd.items():
            assert back[k].dtype == v.dtype, k
            np.testing.assert_array_equal(back[k].numpy(), v.numpy(),
                                          err_msg=k)
        model.load_state_dict(back)  # strict: every key, every shape


def test_sd_sized_names_match_the_jax_converter():
    """At the SD-v1 layout (built on the meta device: no memory), every
    key the JAX converter reads is a key of the port's modules and the
    other way round."""
    with torch.device("meta"):
        unet = UNetModel()
        ae = Autoencoder()
    want_u = {r[1] for r in convert_sd_unet({}, _record=True)}
    want_a = {r[1] for r in convert_sd_autoencoder({}, _record=True)}
    got_u = {k.rsplit(".", 1)[0] for k in unet.state_dict()}
    got_a = {k.rsplit(".", 1)[0] for k in ae.state_dict()}
    # the converter records a skip conv for every block; only those whose
    # width changes have one
    assert got_u <= want_u and {k for k in want_u - got_u
                                if "skip_connection" not in k} == set()
    assert got_a <= want_a and {k for k in want_a - got_a
                                if "nin_shortcut" not in k} == set()
    n_params = sum(p.numel() for p in unet.parameters())
    assert 850e6 < n_params < 870e6, n_params  # SD-v1's 860M UNet


def test_sd_checkpoint_loader_reports_like_jax(tmp_path, tiny):
    """A fabricated SD-layout .ckpt (the JAX package's
    ``fabricate_sd_state_dict`` over tiny flax trees), with one key dropped
    and unused keys added: the port's loader reports the same missing and
    extra keys as the JAX loader and loads the same values."""
    _, _, uparams, aparams = tiny
    sd = fabricate_sd_state_dict(
        uparams, convert_sd_unet({}, _record=True, **UNET_LAYOUT), UP)
    sd.update(fabricate_sd_state_dict(
        aparams, convert_sd_autoencoder({}, ch_mults=AE_MULTS, _record=True),
        AP))
    dropped = UP + "time_embed.2.weight"
    del sd[dropped]
    sd["cond_stage_model.transformer.junk.weight"] = np.zeros(4, np.float32)
    sd["model_ema.decay"] = np.asarray(0.9999, np.float32)
    ck = tmp_path / "tiny_sd.ckpt"
    torch.save({"state_dict": {k: torch.from_numpy(np.atleast_1d(v))
                               for k, v in sd.items()}}, ck)

    _, _, j_missing, j_extra = jax_load_sd_checkpoint(
        str(ck), ae_mults=AE_MULTS, **UNET_LAYOUT)
    torch.manual_seed(5)
    unet, ae = UNetModel(**UNET_KW), Autoencoder(AE_CH, AE_MULTS)
    init_t2 = unet.time_embed[2].weight.detach().clone()
    missing, extra = load_sd_checkpoint(str(ck), unet, ae)
    assert set(missing) == set(j_missing) == {dropped}
    assert extra == sorted(j_extra)
    assert "model_ema.decay" in extra
    torch.testing.assert_close(unet.time_embed[2].weight, init_t2,
                               rtol=0, atol=0)  # kept at init
    np.testing.assert_array_equal(
        unet.input_blocks[1][1].transformer_blocks[0].attn1.to_q.weight
        .detach().numpy(),
        sd[UP + "input_blocks.1.1.transformer_blocks.0.attn1.to_q.weight"])
    np.testing.assert_array_equal(
        ae.decoder.conv_out.weight.detach().numpy(),
        sd[AP + "decoder.conv_out.weight"])


def test_runner_reads_native_ldm_checkpoint(tmp_path, tiny):
    """The {arch, unet, ae} pickle of flax trees that the JAX package's
    ``--mode train_ldm`` writes loads through the bridge."""
    import pickle

    unet, ae, uparams, aparams = tiny
    path = tmp_path / "ldm_native.pkl"
    with open(path, "wb") as f:
        pickle.dump({"arch": "tiny", "unet": uparams, "ae": aparams}, f)
    runner = LdmRunner(arch="tiny", native_ckpt=str(path), device="cpu",
                       verbose=False)
    for mine, ref in ((runner.unet, unet), (runner.ae, ae)):
        for k, v in ref.state_dict().items():
            assert torch.equal(mine.state_dict()[k], v), k
    with pytest.raises(ValueError, match="arch"):
        LdmRunner(arch="mid", native_ckpt=str(path), device="cpu",
                  verbose=False)


# --- entry points ------------------------------------------------------------

def test_cli_txt2img_tiny_writes_images(tmp_path):
    pytest.importorskip("PIL")
    from diffusionmodel_tpu_torch.cli import main

    out = tmp_path / "ldm"
    assert main(["--mode", "txt2img", "--ldm_arch", "tiny", "--steps", "3",
                 "--device", "cpu", "--height", "64", "--width", "64",
                 "--batch_size", "2", "--out_dir", str(out)]) == 0
    assert sorted(os.listdir(out)) == ["txt2img_00000.jpeg",
                                       "txt2img_00001.jpeg"]
    assert main(["--mode", "img2img", "--ldm_arch", "tiny", "--steps", "4",
                 "--device", "cpu", "--height", "64", "--width", "64",
                 "--orig_img", str(out / "txt2img_00000.jpeg"),
                 "--out_dir", str(out)]) == 0
    assert "img2img_00000.jpeg" in os.listdir(out)


def test_cli_edit_modes_need_an_image_and_main_family_is_unported(capsys):
    from diffusionmodel_tpu_torch.cli import main

    assert main(["--mode", "inpaint", "--ldm_arch", "tiny",
                 "--device", "cpu"]) == 1
    assert "--orig_img required" in capsys.readouterr().out
    # the flagship's editing (ported) needs its checkpoint and image too
    assert main(["--mode", "img2img", "--family", "main"]) == 1
    assert "--ckpt and --orig_img required" in capsys.readouterr().out


def test_ldm_runner_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        LdmRunner(arch="tiny")


def test_ldm_helpers_default_to_cuda_and_raise_without_it():
    """``ldm_schedule``, ``LatentDiffusion`` and ``set_seed`` run on the GPU
    unless given a device, as every entry point of the port does."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (ldm_schedule, lambda: LatentDiffusion(None),
                 lambda: set_seed(0)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert ldm_schedule(10, device="cpu").beta.device.type == "cpu"
    assert LatentDiffusion(None, device="cpu").sched.alpha.device.type \
        == "cpu"
    assert set_seed(0, "cpu").device.type == "cpu"


def test_package_never_calls_sdpa():
    """``scaled_dot_product_attention`` is PyTorch's fused attention; the
    port's attention is its own kernel and its plain twin."""
    hits = []
    for path in sorted((REPO / "diffusionmodel_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            name = getattr(node, "attr", getattr(node, "id", None))
            if name == "scaled_dot_product_attention":
                hits.append(f"{path.name}:{node.lineno}")
    assert not hits, hits


def test_group_norm_batch_independent_at_three_threads():
    """At 3 intra-op threads PyTorch's CPU GroupNorm splits its work across
    samples, so a sample's result moved with its batch position; the port's
    GroupNorm normalises a CPU sample on its own."""
    old = torch.get_num_threads()
    torch.set_num_threads(3)
    try:
        torch.manual_seed(0)
        gn = GroupNorm(8, 192)
        x = channels_last(torch.randn(8, 192, 32, 32))
        with torch.no_grad():
            batched = gn(x)
            for i in (0, 3, 7):
                assert torch.equal(gn(x[i:i + 1]), batched[i:i + 1])
        assert batched.is_contiguous(memory_format=torch.channels_last)
    finally:
        torch.set_num_threads(old)
