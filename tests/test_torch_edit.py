"""Main-family image editing (img2img / inpaint over DDIM) against the JAX
package on the CPU: ``diffusion.sample_cfg_edit``, ``sample.edit_samples``
and ``cli --mode img2img|inpaint --family main``.

A tiny ContextUnet (n_feat 16, 32 px, 3 classes, n_T 20, the size of
``tests/test_kernels.py``'s) is built by the port with ``use_pallas`` (on
CPU tensors the kernels' twins) and carried to JAX by the JAX package's
converter. Both packages get the same source images and the same noise:
the start-point draw and, for eta > 0, the per-step draws are the JAX
package's own ``jax.random`` ones, replayed from its key splits and handed
to the port (``noise=``, ``noise_fn=``).

Tolerance: rtol 5e-3 / atol 5e-4 on the edited x_0, what
``tests/test_torch_sampling.py`` holds ``sample_cfg_ddim`` to (PARITY.md's
full-model tolerance, the absolute term widened for a few steps of
accumulation); the kept region of an inpaint exactly (abar_0 = 1, so the
last blend puts the source back bit for bit). The bf16 case (slow) is held
as ``tests/test_torch_bf16.py`` holds its DDIM sampler: nearer to JAX-bf16
than JAX-fp32 is.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusionmodel_tpu import checkpoint as jckpt
from diffusionmodel_tpu import diffusion as jd
from diffusionmodel_tpu import sample as jsample
from diffusionmodel_tpu.compat.torch_convert import convert_context_unet_v2
from diffusionmodel_tpu.config import preset as jpreset
from diffusionmodel_tpu.nn import build_model as jbuild_model
from diffusionmodel_tpu_torch import diffusion as td
from diffusionmodel_tpu_torch import sample as tsample
from diffusionmodel_tpu_torch.config import preset
from diffusionmodel_tpu_torch.nn import build_model

torch.set_num_threads(2)

RTOL, ATOL = 5e-3, 5e-4
TINY = {"model.n_feat": 16, "model.img_size": 32, "model.n_classes": 3,
        "diffusion.n_T": 20}
N, SIZE, STEPS = 2, 32, 4


@pytest.fixture(scope="module")
def pair():
    """(cfg, port model, port schedule, JAX apply_fn, JAX schedule, JAX
    params)."""
    cfg = preset("full", **TINY, **{"model.use_pallas": True})
    torch.manual_seed(0)
    model = build_model(cfg.model, cfg.diffusion.high_thresh, device="cpu")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():  # non-trivial CoordAttn mixing
        for name, p in model.named_parameters():
            if name.split(".")[-1] in ("gamma_h", "gamma_w", "alpha", "beta"):
                p.copy_(torch.randn(p.shape, generator=g))
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    params, _ = convert_context_unet_v2(sd, norm="group")
    jcfg = jpreset("full", **TINY)
    jm = jbuild_model(jcfg.model, jcfg.diffusion.high_thresh)

    def apply_fn(x, c, t, ctx, attn, train):
        return jm.apply({"params": params}, x, c, t, ctx, attn_mask=attn,
                        train=False)

    dc = cfg.diffusion
    return (cfg, model, td.Schedule.create(dc.beta1, dc.beta2, dc.n_T, "cpu"),
            apply_fn, jd.Schedule.create(dc.beta1, dc.beta2, dc.n_T), params)


def _source(seed=3):
    return np.tanh(np.random.RandomState(seed).randn(N, SIZE, SIZE, 3)
                   ).astype(np.float32)


def _mask(kind, seed=4):
    rng = np.random.RandomState(seed)
    shape = {"hw": (SIZE, SIZE), "nhw": (N, SIZE, SIZE),
             "nhwc": (N, SIZE, SIZE, 3)}[kind]
    return (rng.rand(*shape) > 0.5).astype(np.float32)


def _jax_draws(key, x_shape, taus):
    """The JAX edit sampler's draws: the start-point noise (split off
    first), then one per step of the DDIM scan, keyed by tau."""
    key, nkey = jax.random.split(key)
    noise = np.array(jax.random.normal(nkey, x_shape, jnp.float32))
    z = {}
    for tau in taus:
        key, zkey = jax.random.split(key)
        z[int(tau)] = torch.from_numpy(np.array(
            jax.random.normal(zkey, x_shape, jnp.float32)))
    return noise, z


def _taus_used(n_T, strength):
    taus = td.ddim_taus(n_T, STEPS)[::-1]
    k = max(1, min(STEPS, int(round(strength * STEPS))))
    return taus[STEPS - k:]


@pytest.mark.parametrize("mode, mask, strength, eta, guide", [
    ("img2img", None, 0.75, 0.0, 2.0),
    ("inpaint", "hw", 1.0, 0.0, [0.0, 3.0]),
    ("inpaint", "nhw", 0.0, 0.5, 2.0),
    ("inpaint", "nhwc", 0.75, 0.5, 1.5),
    ("img2img", None, 0.5, 0.5, 2.0),
])
def test_edit_matches_jax(pair, mode, mask, strength, eta, guide):
    """img2img and inpaint, the three keep-mask shapes, strengths 0.0
    (k = 1), 0.5, 0.75 and 1.0, eta 0 and 0.5, a per-sample guidance
    vector; the inpaint's kept pixels are the source exactly."""
    cfg, model, sched, apply_fn, jsched, _ = pair
    dc, x0 = cfg.diffusion, _source()
    m = None if mask is None else _mask(mask)
    classes = np.array([2, 0], np.int32)
    key = jax.random.PRNGKey(7)
    want = jd.sample_cfg_edit(
        apply_fn, key, jnp.asarray(x0), 3, jsched, dc,
        guide_w=jnp.asarray(guide, jnp.float32), n_steps=STEPS,
        strength=strength,
        inpaint_mask=None if m is None else jnp.asarray(m),
        classes=jnp.asarray(classes), eta=eta)
    noise, z = _jax_draws(key, x0.shape, _taus_used(dc.n_T, strength))
    got = td.sample_cfg_edit(
        model, None, x0, 3, sched, dc, guide_w=guide, n_steps=STEPS,
        strength=strength, inpaint_mask=m, classes=torch.from_numpy(classes),
        eta=eta, noise=noise, noise_fn=z.__getitem__)
    assert got.shape == x0.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    if m is not None:
        mk = {2: m[None, :, :, None], 3: m[..., None], 4: m}[m.ndim]
        keep = np.broadcast_to(mk, x0.shape) > 0
        np.testing.assert_array_equal(got.numpy()[keep], x0[keep])


@pytest.mark.parametrize("strength, calls", [(0.0, 1), (0.1, 1), (0.6, 2),
                                             (0.75, 3), (1.0, 4),
                                             (2.0, 4)])
def test_edit_runs_round_strength_times_steps(pair, strength, calls):
    """k = max(1, min(n_steps, round(strength * n_steps))) network calls
    on the doubled CFG batch, the last taus of the DDIM sequence; a
    generator alone draws the noise on the schedule's device."""
    cfg, model, sched, *_ = pair
    seen = []

    def eps(x, c, t, ctx):
        seen.append(round(float(t[0]) * cfg.diffusion.n_T))
        assert x.shape[0] == 2 * N
        return model(x, c, t, ctx)

    out = td.sample_cfg_edit(eps, torch.Generator().manual_seed(0),
                             _source(), 3, sched, cfg.diffusion,
                             n_steps=STEPS, strength=strength)
    assert torch.isfinite(out).all()
    assert seen == [int(t) for t in _taus_used(cfg.diffusion.n_T,
                                               strength)]
    assert len(seen) == calls


def _png(path, arr):
    from PIL import Image

    Image.fromarray(arr).save(path)
    return str(path)


def test_edit_samples_and_cli_on_a_jax_checkpoint(pair, tmp_path):
    """``edit_samples`` (inpaint, a mask file, batch 2) on a checkpoint the
    JAX package wrote, against the JAX package's ``edit_samples`` from the
    same seed (its start noise handed in): the same file names, PNGs within
    one level; the image and mask loaders bit-equal; then the CLI's
    ``--mode img2img|inpaint --family main`` writes its files."""
    from PIL import Image

    cfg, model, _, _, _, params = pair
    ck = jckpt.save_checkpoint(str(tmp_path / "ck.pkl"),
                               {"params": params, "batch_stats": {}})
    rng = np.random.RandomState(5)
    src = _png(tmp_path / "src.png",
               rng.randint(0, 256, (40, 40, 3)).astype(np.uint8))
    mask = _png(tmp_path / "mask.png",
                np.where(rng.rand(36, 36) > 0.5, 255, 0).astype(np.uint8))
    for a, b in ((tsample._load_edit_image(src, SIZE, 3),
                  jsample._load_edit_image(src, SIZE, 3)),
                 (tsample._load_keep_mask(mask, SIZE),
                  jsample._load_keep_mask(mask, SIZE)),
                 (tsample._load_keep_mask(None, SIZE),
                  jsample._load_keep_mask(None, SIZE))):
        np.testing.assert_array_equal(a, b)

    kw = dict(mode="inpaint", class_id=1, guide_w=2.0, strength=0.75,
              n_steps=STEPS, mask_path=mask, batch=2, seed=3, verbose=False)
    jcfg = jpreset("full", **TINY)
    jout = jsample.edit_samples(jcfg, ck, src, out_dir=str(tmp_path / "jax"),
                                **kw)
    key, nkey = jax.random.split(jax.random.PRNGKey(3))
    noise = np.array(jax.random.normal(nkey, (2, SIZE, SIZE, 3),
                                       jnp.float32))
    out = tsample.edit_samples(cfg, ck, src, out_dir=str(tmp_path / "port"),
                               device="cpu", noise=noise, **kw)
    assert set(out) == set(jout) | {"images"}
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax")) == ["inpaint_grid.png",
                                           "inpaint_s0.png", "inpaint_s1.png"]
    for name in os.listdir(tmp_path / "jax"):
        a = np.asarray(Image.open(tmp_path / "port" / name), np.int16)
        b = np.asarray(Image.open(tmp_path / "jax" / name), np.int16)
        assert np.abs(a - b).max() <= 1, name
    keep = tsample._load_keep_mask(mask, SIZE) > 0
    x0 = tsample._load_edit_image(src, SIZE, 3)[0]
    np.testing.assert_array_equal(out["images"][0][keep], x0[keep])

    from diffusionmodel_tpu_torch.cli import main

    over = [a for k, v in TINY.items() for a in ("-o", f"{k}={v}")]
    for mode in ("img2img", "inpaint"):
        d = tmp_path / f"cli_{mode}"
        assert main(["--mode", mode, "--family", "main", "--ckpt", ck,
                     "--orig_img", src, "--steps", "2", "--batch_size", "1",
                     "--device", "cpu", "--out_dir", str(d)] + over) == 0
        assert sorted(os.listdir(d)) == [f"{mode}_grid.png", f"{mode}_s0.png"]


@pytest.mark.slow
def test_bf16_edit_nearer_jax_bf16_than_jax_fp32(pair):
    """An inpaint of 3 DDIM steps at bf16 (fp32 parameters) from JAX's own
    draws: nearer to JAX's bf16 edit than JAX's fp32 edit is."""
    cfg, model, sched, _, jsched, params = pair
    dc, x0, m = cfg.diffusion, _source(), _mask("hw")
    key = jax.random.PRNGKey(9)
    res = {}
    for dt in ("float32", "bfloat16"):
        jm = jbuild_model(jpreset("full", **TINY,
                                  **{"model.dtype": dt}).model)

        def run(x0_, m_):
            return jd.sample_cfg_edit(
                lambda x, c, t, ctx, attn, train: jm.apply(
                    {"params": params}, x, c, t, ctx, attn_mask=attn,
                    train=False), key, x0_, 3, jsched, dc, guide_w=2.0,
                n_steps=STEPS, strength=0.75, inpaint_mask=m_)

        res[dt] = np.asarray(jax.jit(run).lower(x0, m).compile(
            compiler_options={"xla_allow_excess_precision": False})(x0, m))
    g = float(np.linalg.norm(res["bfloat16"] - res["float32"])
              / np.linalg.norm(res["float32"]))
    assert g > 1e-3
    # the JAX model's own bf16 SE / CoordAttn lines (the kernels round
    # elsewhere in bf16, in both packages)
    m16 = build_model(preset("full", **TINY, **{
        "model.dtype": "bfloat16"}).model, device="cpu")
    m16.load_state_dict(model.state_dict())
    noise, _ = _jax_draws(key, x0.shape, [])
    got = td.sample_cfg_edit(m16, None, x0, 3, sched, dc, guide_w=2.0,
                             n_steps=STEPS, strength=0.75, inpaint_mask=m,
                             noise=noise).numpy()
    assert np.isfinite(got).all()
    err = float(np.linalg.norm(got - res["bfloat16"])
                / np.linalg.norm(res["bfloat16"]))
    assert err < g, (err, g)
