"""The port's LDM training slice against the JAX package on the CPU.

Weights are drawn by the port (torch seed) and carried to JAX by the JAX
package's own SD converter (``compat/sd_convert``). Both packages get the
same numpy inputs and the same random draws: t, eps, the CFG dropout mask
and the VAE posterior noise are the JAX package's own ``jax.random`` draws,
reproduced here from its key splits (``training.py:65-72,104-116``,
``autoencoder.py:129-131,156-158``) and handed to the port. The tiny UNet
has its flash gate lowered to 32 tokens, so its level-0 self-attentions
(64 tokens of an 8x8 latent) go through ``FlashAttentionFunction``: the
plain forward twin and the plain backward twin here.

Tolerances:
- the Function's gradients against ``jax.vjp`` of the Pallas kernels in
  interpret mode: rtol 5e-4 / atol 5e-5, as ``tests/test_latent_diffusion
  .py`` holds the Pallas backward to XLA (fp32, other summation orders);
- the plain backward twin against autograd of the plain forward: 1e-5
  (the same fp32 arithmetic, rearranged);
- the loss, the UNet gradients and the VAE step's (loss, rec, kl): rtol
  5e-3 / atol 5e-4, PARITY.md's full-model tolerance;
- torch Adam against ``optax.adam`` on identical gradients: rtol 1e-6 /
  atol 1e-9 (the same update, rounded in another order);
- the losses of three whole train steps: rtol 5e-3 / atol 5e-4 too. After
  the first step Adam moves every parameter by about lr whatever the size
  of its gradient, so a parameter whose gradient is rounding noise (a conv
  bias that a one-channel GroupNorm group removes) moves in a direction
  set by that noise, as ``tests/test_ldm_training.py:86-89`` explains;
  such parameters do not reach the loss, which stays within tolerance.
"""

import copy
import json
import os
import pickle

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from diffusionmodel_tpu.compat.sd_convert import (
    convert_sd_autoencoder,
    convert_sd_unet,
)
from diffusionmodel_tpu.data.image_folder import (
    ImageFolderDataset as JImageFolderDataset,
)
from diffusionmodel_tpu.kernels.flash_attn import (
    flash_attention as jax_flash_attention,
)
from diffusionmodel_tpu.models.latent_diffusion import autoencoder as jae
from diffusionmodel_tpu.models.latent_diffusion import training as jtrain
from diffusionmodel_tpu.models.latent_diffusion import unet as junet
from diffusionmodel_tpu.models.latent_diffusion.latent_diffusion import (
    ldm_schedule as jax_ldm_schedule,
)
from diffusionmodel_tpu.models.latent_diffusion.runner import (
    LdmRunner as JLdmRunner,
)
from diffusionmodel_tpu_torch.compat.flax_bridge import (
    autoencoder_flax_from_state_dict,
    autoencoder_state_dict_from_flax,
    ldm_unet_flax_from_state_dict,
    ldm_unet_state_dict_from_flax,
)
from diffusionmodel_tpu_torch.data.image_folder import ImageFolderDataset
from diffusionmodel_tpu_torch.kernels.flash_attn import (
    FlashAttentionFunction,
    flash_attention,
    flash_attention_backward_plain,
    flash_attention_plain,
)
from diffusionmodel_tpu_torch.models.latent_diffusion.autoencoder import (
    Autoencoder,
)
from diffusionmodel_tpu_torch.models.latent_diffusion.latent_diffusion import (
    ldm_schedule,
)
from diffusionmodel_tpu_torch.models.latent_diffusion.runner import (
    ARCHS,
    LdmRunner,
)
from diffusionmodel_tpu_torch.models.latent_diffusion.training import (
    adam,
    fit_ldm,
    ldm_loss,
    make_ae_train_step,
    make_ldm_train_step,
)
from diffusionmodel_tpu_torch.models.latent_diffusion.unet import UNetModel

torch.set_num_threads(2)

RTOL, ATOL = 5e-3, 5e-4
LR = 1e-4
UNET_KW = {k: v for k, v in ARCHS["tiny"].items() if not k.startswith("ae_")}
UNET_LAYOUT = dict(channel_multipliers=UNET_KW["channel_multipliers"],
                   attention_levels=UNET_KW["attention_levels"],
                   n_res_blocks=UNET_KW["n_res_blocks"])
AE_MULTS = ARCHS["tiny"]["ae_mults"]
AE_CH = ARCHS["tiny"]["ae_channels"]
D_COND = UNET_KW["d_cond"]
UP, AP = "model.diffusion_model.", "first_stage_model."
B = 2


def _np(sd):
    return {k: v.detach().numpy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def tiny():
    """Port tiny UNet (gate lowered to 32 tokens) and VAE, and the JAX
    trees made from their state dicts by the JAX converter. Tests that
    train take copies."""
    torch.manual_seed(0)
    unet = UNetModel(flash_min_seq=32, **UNET_KW).to(
        memory_format=torch.channels_last)
    ae = Autoencoder(AE_CH, AE_MULTS).to(memory_format=torch.channels_last)
    uparams, miss_u = convert_sd_unet(
        {UP + k: v for k, v in _np(unet.state_dict()).items()},
        **UNET_LAYOUT)
    aparams, miss_a = convert_sd_autoencoder(
        {AP + k: v for k, v in _np(ae.state_dict()).items()},
        ch_mults=AE_MULTS)
    assert not miss_u and not miss_a
    return unet, ae, uparams, aparams


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(4)
    return dict(z=rng.randn(B, 8, 8, 4).astype(np.float32) * 0.5,
                cond=rng.randn(B, 77, D_COND).astype(np.float32),
                uncond=rng.randn(77, D_COND).astype(np.float32))


def _jax_unet():
    return junet.UNetModel(flash_min_seq=32, **UNET_KW)


def _jax_loss_draws(key, shape, t_max, uncond_prob):
    """The draws of the JAX ``ldm_loss`` (``training.py:65-72``) from its
    key: t, eps and the dropout mask."""
    kt, ke, kd = jax.random.split(key, 3)
    return dict(t=np.array(jax.random.randint(kt, (shape[0],), 0, t_max)),
                eps=np.array(jax.random.normal(ke, shape)),
                drop=np.array(jax.random.bernoulli(kd, uncond_prob,
                                                   (shape[0],))))


def _flat_grads(tree):
    return {k: v.numpy() for k, v in ldm_unet_state_dict_from_flax(
        jax.tree.map(np.asarray, tree), **UNET_LAYOUT).items()}


# --- flash attention's backward ------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 128, 192, 2, 16), (2, 128, 192, 2, 40),
                                   (1, 100, 72, 2, 40)])
def test_flash_function_gradients_match_pallas_interpret(shape):
    """``jax.vjp`` of the Pallas kernels (forward, dQ and dK/dV passes in
    interpret mode, 64-row tiles, the ragged case padded by the JAX
    package) against the Function's backward on the same cotangent."""
    b, n, m, h, d = shape
    rng = np.random.RandomState(d + n)
    q, do = (rng.randn(b, n, h, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, m, h, d).astype(np.float32) for _ in range(2))
    out, vjp = jax.vjp(lambda *a: jax_flash_attention(
        *a, block_q=64, block_k=64, interpret=True), *map(jnp.asarray,
                                                           (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = flash_attention(tq, tk, tv)
    assert o.grad_fn is not None and \
        type(o.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(out),
                               rtol=5e-4, atol=5e-5)
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-4,
                                   atol=5e-5)


@pytest.mark.parametrize("shape", [(2, 50, 50, 3, 16), (1, 37, 91, 2, 40)])
def test_backward_twin_matches_autograd_of_the_plain_forward(shape):
    b, n, m, h, d = shape
    g = torch.Generator().manual_seed(n)
    q, do = (torch.randn((b, n, h, d), generator=g) for _ in range(2))
    k, v = (torch.randn((b, m, h, d), generator=g) for _ in range(2))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    o, lse = flash_attention_plain(q, k, v, want_lse=True)
    want = torch.autograd.grad(o, (q, k, v), do)
    got = flash_attention_backward_plain(q.detach(), k.detach(), v.detach(),
                                         o.detach(), lse.detach(), do)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=1e-5)
    # under no_grad the Function is bypassed: no graph, no logsumexp asked
    with torch.no_grad():
        assert flash_attention(q, k, v).grad_fn is None
    o2, lse2 = FlashAttentionFunction.apply(q, k, v)
    assert lse2.requires_grad is False and o2.requires_grad


# --- the loss and the train step -----------------------------------------------

@pytest.fixture(scope="module")
def jax_step(batch):
    """The JAX package's train step as ``make_ldm_train_step`` builds it
    (``training.py:120-128``) over latents, with CFG dropout 0.5:
    ``value_and_grad`` of its ``ldm_loss`` (params, key, z0) -> (loss,
    grads), and the ``optax.adam`` update (grads, state, params) ->
    (params, state), each jitted once."""
    ju, jsched, tx = _jax_unet(), jax_ldm_schedule(), optax.adam(LR)
    cond, uncond = jnp.asarray(batch["cond"]), jnp.asarray(batch["uncond"])

    def apply(p, zt, t, c):
        return ju.apply({"params": p}, zt, t, c)

    def update(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    value_and_grad = jax.jit(jax.value_and_grad(
        lambda p, key, z0: jtrain.ldm_loss(apply, p, key, z0, cond, jsched,
                                           uncond, 0.5)))
    return value_and_grad, jax.jit(update), tx


def test_ldm_loss_and_unet_gradients_match_jax(tiny, batch, jax_step):
    """One ``ldm_loss`` with CFG dropout: the loss and every UNet gradient
    against ``jax.value_and_grad`` on the same weights and draws."""
    unet, _, uparams, _ = tiny
    unet = copy.deepcopy(unet)
    key = jax.random.PRNGKey(8)
    jloss, jgrads = jax_step[0](uparams, key, jnp.asarray(batch["z"]))
    draws = _jax_loss_draws(key, batch["z"].shape, 1000, 0.5)
    assert draws["drop"].tolist() == [True, False]
    loss = ldm_loss(unet, torch.from_numpy(batch["z"]),
                    torch.from_numpy(batch["cond"]), ldm_schedule(),
                    torch.from_numpy(batch["uncond"]), 0.5, **draws)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
    want = _flat_grads(jgrads)
    got = dict(unet.named_parameters())
    assert set(want) == set(got)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), w, rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_torch_adam_matches_optax_adam():
    rng = np.random.RandomState(0)
    params = {"w": rng.randn(5, 7).astype(np.float32),
              "b": rng.randn(7).astype(np.float32)}
    tx = optax.adam(1e-3)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)

    @jax.jit
    def update(grads, state, jp):
        updates, state = tx.update(grads, state, jp)
        return optax.apply_updates(jp, updates), state

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = adam(tp.values(), 1e-3)
    for _ in range(3):
        grads = {k: rng.randn(*v.shape).astype(np.float32) * 10 ** rng.uniform(
            -6, 1) for k, v in params.items()}
        jp, state = update(jax.tree.map(jnp.asarray, grads), state, jp)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        for k, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-9)


def test_three_train_steps_match_jax(tiny, batch, jax_step):
    """``make_ldm_train_step`` over (mean, std) posterior moments, three
    steps, against the JAX package's step (``training.py:104-128``): a
    posterior draw from ``kz``, the loss's draws from ``kl``."""
    unet, _, uparams, _ = tiny
    unet = copy.deepcopy(unet)
    value_and_grad, update, tx = jax_step
    # Adam is elementwise: run it on the raveled tree, which compiles in a
    # fraction of the time the per-leaf update takes
    flat, unravel = ravel_pytree(uparams)
    opt_state = tx.init(flat)
    step = make_ldm_train_step(unet, adam(unet.parameters(), LR),
                               ldm_schedule(), uncond_prob=0.5)
    mean = batch["z"]
    std = np.full_like(mean, 0.1)
    args = [torch.from_numpy(a) for a in (batch["cond"], batch["uncond"])]
    for i in range(3):
        kz, kl = jax.random.split(jax.random.PRNGKey(100 + i))
        z_noise = np.array(jax.random.normal(kz, mean.shape))
        z0 = 0.18215 * (jnp.asarray(mean) + jnp.asarray(std) * z_noise)
        jloss, grads = value_and_grad(unravel(flat), kl, z0)
        flat, opt_state = update(ravel_pytree(grads)[0], opt_state, flat)
        loss = step((torch.from_numpy(mean), torch.from_numpy(std)), args[0],
                    uncond_cond=args[1], z_noise=z_noise,
                    **_jax_loss_draws(kl, mean.shape, 1000, 0.5))
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL,
                                   atol=ATOL, err_msg=f"step {i}")


def test_ae_train_step_matches_jax():
    """Two ``make_ae_train_step`` steps (reconstruction L1 + 1e-6 KL): the
    (loss, rec, kl) of each against the JAX package's step, on a one-level
    VAE (8 px images and latents) whose graph compiles quickly."""
    torch.manual_seed(2)
    ae = Autoencoder(32, (1,)).to(memory_format=torch.channels_last)
    aparams, missing = convert_sd_autoencoder(
        {AP + k: v for k, v in _np(ae.state_dict()).items()}, ch_mults=(1,))
    assert not missing
    img = np.random.RandomState(5).uniform(-1, 1, (B, 8, 8, 3)).astype(
        np.float32)
    tx = optax.adam(LR)
    state = jtrain.LdmTrainState(aparams, tx.init(aparams),
                                 jnp.zeros((), jnp.int32))
    jstep = jax.jit(jtrain.make_ae_train_step(
        jae.Autoencoder(channels=32, ch_mults=(1,)), tx))
    step = make_ae_train_step(ae, adam(ae.parameters(), LR))
    for i in range(2):
        key = jax.random.PRNGKey(30 + i)
        state, want = jstep(state, key, jnp.asarray(img))
        # the JAX module samples its posterior with the step's key itself
        noise = np.array(jax.random.normal(key, (B, 8, 8, 4)))
        got = step(torch.from_numpy(img), noise=noise)
        for name, g, w in zip(("loss", "rec", "kl"), got, want):
            np.testing.assert_allclose(g.item(), float(w), rtol=RTOL,
                                       atol=ATOL, err_msg=f"step {i} {name}")


def test_frozen_vae_gets_no_gradient_and_full_dropout_ignores_cond(tiny,
                                                                   batch):
    unet, ae, _, _ = tiny
    unet, ae = copy.deepcopy(unet), copy.deepcopy(ae)
    ae_before = {k: v.clone() for k, v in ae.state_dict().items()}
    unet_before = {k: v.clone() for k, v in unet.state_dict().items()}
    step = make_ldm_train_step(unet, adam(unet.parameters(), 1e-3),
                               ldm_schedule(), ae=ae)
    img = torch.from_numpy(np.random.RandomState(6).uniform(
        -1, 1, (B, 64, 64, 3)).astype(np.float32))
    loss = step(img, torch.from_numpy(batch["cond"]),
                generator=torch.Generator().manual_seed(0))
    assert np.isfinite(loss.item())
    assert all(p.grad is None for p in ae.parameters())
    assert all(torch.equal(v, ae_before[k])
               for k, v in ae.state_dict().items())
    assert any(not torch.equal(v, unet_before[k])
               for k, v in unet.state_dict().items())
    # uncond_prob = 1: every sample trains against the empty prompt
    z = torch.from_numpy(batch["z"])
    uncond = torch.from_numpy(batch["uncond"])
    losses = []
    for seed in (1, 2):
        cond = torch.randn((B, 77, D_COND),
                           generator=torch.Generator().manual_seed(seed))
        with torch.no_grad():
            losses.append(ldm_loss(unet, z, cond, ldm_schedule(), uncond, 1.0,
                                   generator=torch.Generator().manual_seed(9)))
    assert losses[0].item() == losses[1].item()


def test_remat_gives_the_same_gradients(tiny, batch):
    unet, _, _, _ = tiny
    draws = _jax_loss_draws(jax.random.PRNGKey(3), batch["z"].shape, 1000,
                            0.0)
    grads = []
    for remat in (False, True):
        model = copy.deepcopy(unet)
        step = make_ldm_train_step(
            model, torch.optim.SGD(model.parameters(), lr=0.0),
            ldm_schedule(), remat=remat)
        step(torch.from_numpy(batch["z"]), torch.from_numpy(batch["cond"]),
             t=draws["t"], eps=draws["eps"])
        grads.append({k: p.grad for k, p in model.named_parameters()})
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=0, atol=1e-6,
                                   msg=name)


# --- checkpoints, data and the CLI ---------------------------------------------

def test_inverse_bridge_matches_the_jax_converter(tiny):
    """state_dict -> flax trees: leaf for leaf the trees the JAX package's
    ``convert_sd_unet`` / ``convert_sd_autoencoder`` build, bit for bit,
    and back to the same state_dict."""
    unet, ae, uparams, aparams = tiny
    for model, mine, want, back in (
            (unet, ldm_unet_flax_from_state_dict(unet.state_dict(),
                                                 **UNET_LAYOUT),
             uparams, lambda t: ldm_unet_state_dict_from_flax(
                 t, **UNET_LAYOUT)),
            (ae, autoencoder_flax_from_state_dict(ae.state_dict(), AE_MULTS),
             aparams, lambda t: autoencoder_state_dict_from_flax(
                 t, AE_MULTS))):
        flat_mine = jax.tree_util.tree_flatten_with_path(mine)[0]
        flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
        assert len(flat_mine) == len(flat_want)
        for path, leaf in flat_mine:
            assert leaf.dtype == np.float32
            np.testing.assert_array_equal(leaf, flat_want[path],
                                          err_msg=str(path))
        for k, v in back(mine).items():
            assert torch.equal(v, model.state_dict()[k]), k


def test_fit_ldm_checkpoint_loads_in_both_runners(tmp_path, monkeypatch):
    """``fit_ldm`` writes the JAX package's pickle; the port's and the JAX
    package's ``LdmRunner(native_ckpt=...)`` both load it and give the
    same eps on the same input. The JAX runner's random initialisation,
    which the checkpoint replaces, is stubbed out: compiling it costs
    about 30 s on the CPU."""
    runner = LdmRunner(arch="tiny", device="cpu", verbose=False, seed=1)
    rng = np.random.RandomState(8)
    images = rng.uniform(-1, 1, (5, 64, 64, 3)).astype(np.float32)
    path = str(tmp_path / "ldm_native.pkl")
    logs = []
    state, hist = fit_ldm(runner, images, ["a crack"] * 3 + ["a road"] * 2,
                          epochs=2, batch_size=2, lr=1e-3, seed=0,
                          out_path=path, log=logs.append)
    assert state.steps == 4 and len(hist) == 2 and np.isfinite(hist).all()
    assert "saved" in logs[-1]
    with open(path, "rb") as f:
        assert set(pickle.load(f)) == {"arch", "unet", "ae"}
    mine = LdmRunner(arch="tiny", device="cpu", verbose=False, seed=5,
                     native_ckpt=path)
    for a, b in ((mine.unet, runner.unet), (mine.ae, runner.ae)):
        for k, v in b.state_dict().items():
            assert torch.equal(a.state_dict()[k], v), k
    for cls in (junet.UNetModel, jae.Autoencoder):
        monkeypatch.setattr(cls, "init", lambda self, *a, **k: {"params": {}})
    jrun = JLdmRunner(arch="tiny", use_flash=False, use_clip=False,
                      verbose=False, native_ckpt=path)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    t = np.array([17, 640])
    cond = rng.randn(2, 77, D_COND).astype(np.float32)
    want = jax.jit(jrun.unet.apply)({"params": jrun.params}, jnp.asarray(x),
                                    jnp.asarray(t), jnp.asarray(cond))
    with torch.no_grad():
        got = mine.unet(torch.from_numpy(x), torch.from_numpy(t),
                        torch.from_numpy(cond))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    with pytest.raises(ValueError, match="batch_size"):
        fit_ldm(runner, images[:1], ["a"], batch_size=2)
    with pytest.raises(ValueError, match="prompts"):
        fit_ldm(runner, images, ["a"], batch_size=2)


def _write_pngs(root, classes, n, size=64):
    from PIL import Image

    rng = np.random.RandomState(0)
    for cls in classes:
        d = root / cls
        d.mkdir(parents=True)
        for i in range(n):
            Image.fromarray(rng.randint(0, 255, (size, size, 3), np.uint8)
                            ).save(d / f"{i}.png")


def test_cli_train_ldm_round_trip(tmp_path, capsys):
    """--mode train_ldm (VAE first, then the UNet) on a folder of PNGs,
    then --mode txt2img on its checkpoint; the dataset copy reads the
    folder as the JAX package's does."""
    pytest.importorskip("PIL")
    from diffusionmodel_tpu_torch.cli import main

    data = tmp_path / "data"
    _write_pngs(data, ("ant", "bee"), 2, size=40)
    ds, jds = (cls(str(data), img_size=32, normalize=True)
               for cls in (ImageFolderDataset, JImageFolderDataset))
    assert ds.classes == jds.classes == ["ant", "bee"]
    np.testing.assert_array_equal(ds.labels, jds.labels)
    for i in range(len(ds)):
        np.testing.assert_array_equal(ds.load(i)[0], jds.load(i)[0])

    out = tmp_path / "out"
    assert main(["--mode", "train_ldm", "--data_root", str(data),
                 "--ldm_arch", "tiny", "--device", "cpu", "--img_size", "64",
                 "--epochs", "1", "--batch_size", "4", "--train_ae_epochs",
                 "1", "--out_dir", str(out), "--seed", "0"]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()
             if s.startswith("{")]
    assert lines[0]["stage"] == "train_ae" and lines[0]["epochs"] == 1
    summary = lines[1]
    ckpt = str(out / "ldm_native.pkl")
    assert summary["mode"] == "train_ldm" and summary["images"] == 4
    assert summary["ckpt"] == ckpt and np.isfinite(summary["last_loss"])
    img_dir = tmp_path / "img"
    assert main(["--mode", "txt2img", "--ldm_arch", "tiny", "--device", "cpu",
                 "--ldm_native", ckpt, "--prompt", "a photo of a ant",
                 "--height", "64", "--width", "64", "--steps", "3",
                 "--out_dir", str(img_dir)]) == 0
    assert sorted(os.listdir(img_dir)) == ["txt2img_00000.jpeg"]
    assert main(["--mode", "train_ldm", "--data_root", str(data),
                 "--img_size", "60", "--device", "cpu"]) == 1
    assert main(["--mode", "train_ldm", "--device", "cpu"]) == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--mode", "train_ldm", "--data_root", str(data),
                  "--ldm_arch", "tiny", "--img_size", "64"])
