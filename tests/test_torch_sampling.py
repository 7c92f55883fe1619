"""The port's CFG samplers against the JAX package's on the same weights.

A tiny ContextUnet (n_feat 8, 32 px, 3 classes, n_T 10) is built by the
port, carried to JAX by the JAX package's converter, and both packages
sample from the same numpy start noise. DDIM (eta 0) and DPM++ are
deterministic given x_T; the stochastic paths (ancestral, DDIM eta > 0)
get the JAX package's own per-step draws through the port's ``noise_fn``.

Tolerance: rtol 5e-3 / atol 5e-4 on x_0, the full model's per-call
tolerance (PARITY.md: fp32 conv stacks summed in other orders) with the
absolute term widened for a few steps of accumulation. The per-step
coefficients are exact: ``ddim_taus`` and ``dpmpp_terms`` are compared
bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusionmodel_tpu import diffusion as jd
from diffusionmodel_tpu.compat.torch_convert import convert_context_unet_v2
from diffusionmodel_tpu.config import preset as jax_preset
from diffusionmodel_tpu.nn import build_model as jax_build_model
from diffusionmodel_tpu_torch import diffusion as td
from diffusionmodel_tpu_torch.config import preset
from diffusionmodel_tpu_torch.nn import build_model

torch.set_num_threads(2)

RTOL, ATOL = 5e-3, 5e-4
TINY = {"model.n_feat": 8, "model.img_size": 32, "model.n_classes": 3,
        "diffusion.n_T": 10, "sample.ddim_steps": 4, "sample.dpm_steps": 4}
SHAPE = (32, 32, 3)
N = 3


@pytest.fixture(scope="module")
def pair():
    """(cfg, port model, port schedule, JAX apply_fn, JAX schedule)."""
    cfg = preset("full", **TINY)
    torch.manual_seed(0)
    model = build_model(cfg.model, cfg.diffusion.high_thresh, device="cpu")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():  # non-trivial CoordAttn mixing
        for name, p in model.named_parameters():
            if name.split(".")[-1] in ("gamma_h", "gamma_w", "alpha", "beta"):
                p.copy_(torch.randn(p.shape, generator=g))
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    params, _ = convert_context_unet_v2(sd, norm="group")
    jcfg = jax_preset("full", **TINY)
    jm = jax_build_model(jcfg.model, jcfg.diffusion.high_thresh)

    def apply_fn(x, c, t, ctx, attn, train):
        return jm.apply({"params": params}, x, c, t, ctx, attn_mask=attn,
                        train=False)

    dc = cfg.diffusion
    return (cfg, model, td.Schedule.create(dc.beta1, dc.beta2, dc.n_T, "cpu"),
            apply_fn, jd.Schedule.create(dc.beta1, dc.beta2, dc.n_T))


def _x_init(seed=3):
    return np.random.RandomState(seed).randn(N, *SHAPE).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n_T, n_steps, disc", [
    (10, 4, "uniform"), (10, 4, "quad"), (700, 50, "uniform"),
    (700, 50, "quad"), (30, 25, "quad")])
def test_ddim_taus_equal(n_T, n_steps, disc):
    np.testing.assert_array_equal(td.ddim_taus(n_T, n_steps, disc),
                                  jd.ddim_taus(n_T, n_steps, disc))


def test_dpmpp_terms_bit_equal(pair):
    cfg, _, sched, _, jsched = pair
    for n_T, steps, disc in ((10, 4, "uniform"), (700, 20, "uniform"),
                             (700, 20, "quad")):
        t_sched = td.Schedule.create(1e-4, 0.02, n_T, "cpu")
        j_sched = jd.Schedule.create(1e-4, 0.02, n_T)
        taus, terms = td._dpmpp_coeffs(t_sched, n_T, steps, disc)
        jtaus, *jterms = jd._dpmpp_coeffs(j_sched, n_T, steps, disc)
        np.testing.assert_array_equal(taus, np.asarray(jtaus))
        assert len(terms) == len(jterms) == 6
        for a, b in zip(terms, jterms):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("disc, guide", [("uniform", 2.0),
                                         ("quad", [0.0, 2.0, 5.0])])
def test_ddim_trajectory_matches_jax(pair, disc, guide):
    cfg, model, sched, apply_fn, jsched = pair
    dc, x0 = cfg.diffusion, _x_init()
    classes = np.array([0, 2, 1], np.int32)
    want = jd.sample_cfg_ddim(
        apply_fn, jax.random.PRNGKey(0), N, SHAPE, 3, jsched, dc,
        guide_w=jnp.asarray(guide, jnp.float32), n_steps=4, eta=0.0,
        classes=jnp.asarray(classes), discretize=disc,
        x_init=jnp.asarray(x0))
    got = td.sample_cfg_ddim(
        model, None, N, SHAPE, 3, sched, dc, guide_w=guide, n_steps=4,
        eta=0.0, classes=torch.from_numpy(classes), discretize=disc,
        x_init=x0)
    assert got.shape == (N, *SHAPE)
    _close(got, want)


def _jax_step_noise(key, steps):
    """The per-step z of the JAX samplers' scans, keyed by step: each
    sampler splits off the x_T key first, then one key per step."""
    key, _ = jax.random.split(key)
    out = {}
    for s in steps:
        key, zkey = jax.random.split(key)
        out[int(s)] = torch.from_numpy(np.array(
            jax.random.normal(zkey, (N, *SHAPE), jnp.float32)))
    return out


def test_ddim_eta_with_injected_noise_matches_jax(pair):
    cfg, model, sched, apply_fn, jsched = pair
    dc, x0, key = cfg.diffusion, _x_init(4), jax.random.PRNGKey(5)
    want = jd.sample_cfg_ddim(apply_fn, key, N, SHAPE, 3, jsched, dc,
                              guide_w=1.5, n_steps=4, eta=0.5,
                              x_init=jnp.asarray(x0))
    z = _jax_step_noise(key, td.ddim_taus(dc.n_T, 4)[::-1])
    got = td.sample_cfg_ddim(model, None, N, SHAPE, 3, sched, dc,
                             guide_w=1.5, n_steps=4, eta=0.5, x_init=x0,
                             noise_fn=z.__getitem__)
    _close(got, want)


def test_dpmpp_trajectory_matches_jax(pair):
    cfg, model, sched, apply_fn, jsched = pair
    dc, x0 = cfg.diffusion, _x_init(6)
    want = jd.sample_cfg_dpmpp(apply_fn, jax.random.PRNGKey(0), N, SHAPE, 3,
                               jsched, dc, guide_w=3.0, n_steps=4,
                               x_init=jnp.asarray(x0))
    got = td.sample_cfg_dpmpp(model, None, N, SHAPE, 3, sched, dc,
                              guide_w=3.0, n_steps=4, x_init=x0)
    _close(got, want)


def test_ancestral_with_injected_noise_matches_jax(pair):
    """The full n_T..1 loop, and a chunk of it padded with 0 no-op steps
    (the JAX package's chunked-run convention)."""
    cfg, model, sched, apply_fn, jsched = pair
    dc, x0, key = cfg.diffusion, _x_init(7), jax.random.PRNGKey(8)
    want = jd.sample_cfg(apply_fn, key, N, SHAPE, 3, jsched, dc, guide_w=2.0,
                         x_init=jnp.asarray(x0))
    z = _jax_step_noise(key, range(dc.n_T, 0, -1))
    got = td.sample_cfg(model, None, N, SHAPE, 3, sched, dc, guide_w=2.0,
                        x_init=x0, noise_fn=z.__getitem__)
    _close(got, want)

    steps = np.array([3, 2, 1, 0, 0], np.int32)
    want = jd.sample_cfg(apply_fn, key, N, SHAPE, 3, jsched, dc, guide_w=2.0,
                         x_init=jnp.asarray(x0), steps=jnp.asarray(steps))
    z = _jax_step_noise(key, steps)
    got = td.sample_cfg(model, None, N, SHAPE, 3, sched, dc, guide_w=2.0,
                        x_init=x0, steps=steps, noise_fn=z.__getitem__)
    _close(got, want)


def test_fixed_orientation_and_guide_validation(pair):
    cfg, model, sched, _, _ = pair
    c2, mask2 = td._cfg_inputs(4, 3, cfg.diffusion, None, "cpu")
    assert c2.tolist() == [0, 1, 2, 0] * 2
    assert mask2.tolist() == [0.0] * 4 + [1.0] * 4
    fixed = cfg.diffusion.__class__(cfg_fixed_orientation=True)
    assert td._cfg_inputs(4, 3, fixed, None, "cpu")[1].tolist() == \
        [1.0] * 4 + [0.0] * 4
    with pytest.raises(ValueError, match="guide_w"):
        td.sample_cfg_ddim(model, None, N, SHAPE, 3, sched, cfg.diffusion,
                           guide_w=[1.0, 2.0], n_steps=2, x_init=_x_init())
