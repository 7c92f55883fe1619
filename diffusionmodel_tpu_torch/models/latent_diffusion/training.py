"""LDM training (counterpart of
``diffusionmodel_tpu/models/latent_diffusion/training.py``): the eps-loss
train step of the latent UNet behind a frozen VAE, ``fit_ldm`` behind
``--mode train_ldm``, and first-stage (VAE) training with ``fit_ae``.

- The loss is the simplified eps-MSE on latents, in fp32: t ~ U[0, T) per
  sample against the LDM schedule, z_t = sqrt(abar) z0 + sqrt(1 - abar) eps,
  and with ``uncond_prob`` each sample's conditioning replaced by the empty
  prompt's (classifier-free-guidance dropout).
- Every random draw can be injected (the posterior noise, t, eps and the
  dropout mask), which is how the tests hand the port the JAX package's own
  ``jax.random`` draws; otherwise they come from a ``torch.Generator``, in
  that order.
- The VAE is frozen: it encodes under ``torch.no_grad`` and gets no
  gradient. ``remat=True`` wraps the whole UNet call in
  ``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint``), so the
  backward recomputes the forward instead of keeping its activations.
- The optimizer is ``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)``,
  ``optax.adam``'s update (eps outside the square root).
- The self-attentions at or above the UNet's flash gate run the CUDA
  flash-attention kernels forward and backward
  (``kernels.flash_attn.FlashAttentionFunction``).

PyTorch updates the modules and the optimizer state in place, so a step
returns only its loss; the JAX package's jitted step returns a new state.
Its per-shape ``jit`` (padding the last encode chunk to one compiled
shape, donated buffers) has no counterpart here.
"""

from __future__ import annotations

import os
import pickle
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from diffusionmodel_tpu_torch.compat.flax_bridge import (
    autoencoder_flax_from_state_dict,
    ldm_unet_flax_from_state_dict,
)
from diffusionmodel_tpu_torch.models.latent_diffusion.latent_diffusion import (
    LdmSchedule,
    ldm_schedule,
)

LATENT_SCALING = 0.18215


class LdmTrainState(NamedTuple):
    """What a fit trained, in place: the module, its optimizer and the
    number of optimizer steps taken."""

    model: nn.Module
    opt: torch.optim.Optimizer
    steps: int


def adam(params, lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)``: b1 0.9, b2 0.999, eps 1e-8 added outside the
    square root of the bias-corrected second moment."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def _device_of(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


def _given(x, like: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=like.device)


def ldm_loss(unet_apply: Callable, z0: torch.Tensor, cond: torch.Tensor,
             sched: LdmSchedule, uncond_cond: Optional[torch.Tensor] = None,
             uncond_prob: float = 0.0, *, t=None, eps=None, drop=None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Simplified eps-MSE on latents, in fp32 whatever the model computes
    in. ``t`` [B] int, ``eps`` like z0 and ``drop`` [B] bool are drawn from
    ``generator`` unless given (arrays or tensors)."""
    b = z0.shape[0]
    if t is None:
        t = torch.randint(0, sched.alpha_bar.shape[0], (b,),
                          generator=generator, device=z0.device)
    t = _given(t, z0, torch.long)
    if eps is None:
        eps = torch.randn(z0.shape, generator=generator, device=z0.device)
    eps = _given(eps, z0)
    abar = sched.alpha_bar[t].float()[:, None, None, None]
    zt = abar.sqrt() * z0 + (1.0 - abar).sqrt() * eps
    if uncond_cond is not None and uncond_prob > 0.0:
        if drop is None:
            drop = torch.rand(b, generator=generator,
                              device=z0.device) < uncond_prob
        drop = _given(drop, z0, torch.bool)
        cond = torch.where(drop[:, None, None], uncond_cond, cond)
    pred = unet_apply(zt, t, cond)
    return torch.mean(torch.square(eps.float() - pred.float()))


def make_ldm_train_step(unet: nn.Module, opt: torch.optim.Optimizer,
                        sched: Optional[LdmSchedule] = None,
                        ae: Optional[nn.Module] = None,
                        latent_scaling: float = LATENT_SCALING,
                        uncond_prob: float = 0.0, remat: bool = False):
    """Returns ``step(batch, cond, uncond_cond=None, generator=None, *,
    z_noise=None, t=None, eps=None, drop=None) -> loss`` (a detached
    scalar tensor), which updates ``unet`` through ``opt`` in place.

    batch: images [B, H, W, 3] when ``ae`` is given (the frozen VAE encodes
    them and a posterior sample is drawn, H and W 8x the latent size), else
    latents [B, h, w, z], or a ``(mean, std)`` tuple of unscaled posterior
    moments (what ``fit_ldm`` caches: one encode of the dataset, then a
    fresh posterior sample per step). ``z_noise`` is that posterior noise.
    """
    sched = sched or ldm_schedule(device=_device_of(unet))

    def unet_apply(zt, t, cond):
        if remat:
            return checkpoint(unet, zt, t, cond, use_reentrant=False)
        return unet(zt, t, cond)

    def step(batch, cond, uncond_cond=None, generator=None, *, z_noise=None,
             t=None, eps=None, drop=None) -> torch.Tensor:
        with torch.no_grad():
            if ae is not None:
                z0 = latent_scaling * ae.encode(batch).sample(generator,
                                                              z_noise)
            elif isinstance(batch, tuple):
                mean, std = batch
                if z_noise is None:
                    z_noise = torch.randn(mean.shape, generator=generator,
                                          device=mean.device)
                z0 = latent_scaling * (mean + std * _given(z_noise, mean))
            else:
                z0 = batch
        opt.zero_grad(set_to_none=True)
        loss = ldm_loss(unet_apply, z0, cond, sched, uncond_cond,
                        uncond_prob, t=t, eps=eps, drop=drop,
                        generator=generator)
        loss.backward()
        opt.step()
        return loss.detach()

    return step


def _batches(n: int, batch_size: int, rng: np.random.RandomState):
    """One epoch of index batches: a seeded permutation, the last partial
    batch dropped (the JAX package's order, from the same numpy seed)."""
    order = rng.permutation(n)
    for i in range(0, n - batch_size + 1, batch_size):
        yield order[i:i + batch_size]


def save_ldm_native(runner, path: str) -> None:
    """Write ``{"arch", "unet", "ae"}`` with flax-named numpy trees: the
    JAX package's ``train_ldm`` pickle, which both packages' ``LdmRunner(
    native_ckpt=...)`` load. The VAE rides along because the UNet was
    trained in its latent space."""
    from diffusionmodel_tpu_torch.models.latent_diffusion.runner import ARCHS

    a = ARCHS[runner.arch]
    payload = {
        "arch": runner.arch,
        "unet": ldm_unet_flax_from_state_dict(
            runner.unet.state_dict(), a["channel_multipliers"],
            a["attention_levels"], a.get("n_res_blocks", 2)),
        "ae": autoencoder_flax_from_state_dict(runner.ae.state_dict(),
                                               a["ae_mults"]),
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def fit_ldm(runner, images: np.ndarray, prompts: Sequence[str], *,
            epochs: int = 10, batch_size: int = 4, lr: float = 1e-4,
            uncond_prob: float = 0.1, remat: bool = False, seed: int = 0,
            out_path: Optional[str] = None, log=print):
    """Train ``runner.unet`` in place behind ``--mode train_ldm``.

    images: [N, H, W, 3] float in [-1, 1] (H = W = 8x the latent size);
    prompts: N strings, conditioned through the runner's prompt-hash
    embedding (the same one sampling uses). The conditioning and the
    frozen VAE's posterior moments are computed once, in chunks of
    ``batch_size`` under ``no_grad``, and kept on the device; each step
    draws a fresh posterior sample from them. Epochs are seeded numpy
    permutations with the last partial batch dropped. Returns
    ``(LdmTrainState, history)`` with the mean loss of each epoch; with
    ``out_path`` the trained UNet and the VAE are written as the JAX
    package's pickle (:func:`save_ldm_native`)."""
    n = int(images.shape[0])
    if len(prompts) != n:
        raise ValueError(f"{n} images but {len(prompts)} prompts")
    if n < batch_size:
        raise ValueError(f"need >= batch_size={batch_size} images, got {n}")
    dev = runner.device
    cond_all = runner.cond(list(prompts))
    uncond = runner.cond([""])[0]
    means, stds = [], []
    with torch.no_grad():
        for i in range(0, n, batch_size):
            chunk = torch.as_tensor(np.asarray(images[i:i + batch_size],
                                               np.float32), device=dev)
            dist = runner.ae.encode(chunk)
            means.append(dist.mean)
            stds.append(dist.std)
    mean_all, std_all = torch.cat(means), torch.cat(stds)

    opt = adam(runner.unet.parameters(), lr)
    step = make_ldm_train_step(runner.unet, opt, uncond_prob=uncond_prob,
                               remat=remat)
    rng = np.random.RandomState(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    history, steps = [], 0
    for ep in range(epochs):
        losses = []
        for idx in _batches(n, batch_size, rng):
            idx = torch.as_tensor(idx, device=dev)
            losses.append(step((mean_all[idx], std_all[idx]), cond_all[idx],
                               uncond_cond=uncond, generator=gen))
            steps += 1
        history.append(torch.stack(losses).mean().item())
        log(f"[train_ldm] epoch {ep + 1}/{epochs} loss {history[-1]:.4f}")
    if out_path:
        save_ldm_native(runner, out_path)
        log(f"[train_ldm] saved UNet params: {out_path}")
    return LdmTrainState(runner.unet, opt, steps), history


# ---------------------------------------------------------------------------
# First-stage (VAE) training: pixel reconstruction (L1, or MSE) plus
# kl_weight x KL(posterior || N(0, 1)), the tractable half of SD's
# first-stage recipe; the perceptual and adversarial terms need pretrained
# networks and are left out, as in the JAX package.
# ---------------------------------------------------------------------------


def make_ae_train_step(ae: nn.Module, opt: torch.optim.Optimizer,
                       kl_weight: float = 1e-6, l1: bool = True):
    """Returns ``step(batch, generator=None, noise=None) -> (loss, rec,
    kl)`` (detached scalars), which updates ``ae`` through ``opt`` in
    place. batch: images [B, H, W, 3] in [-1, 1]; ``noise`` is the
    posterior draw (else from ``generator``).

    rec = mean |x - x̂| (``l1=False``: mean squared error);
    kl = mean over batch and space of 0.5 Σ_c (μ² + σ² − 1 − log σ²)."""

    def step(batch, generator=None, noise=None):
        opt.zero_grad(set_to_none=True)
        recon, dist = ae(batch, generator, noise)
        x, r = batch.float(), recon.float()
        rec = (x - r).abs().mean() if l1 else (x - r).square().mean()
        mean, logvar = dist.mean.float(), dist.logvar.float()
        kl = 0.5 * torch.mean(torch.sum(
            mean.square() + logvar.exp() - 1.0 - logvar, dim=-1))
        loss = rec + kl_weight * kl
        loss.backward()
        opt.step()
        return loss.detach(), rec.detach(), kl.detach()

    return step


def fit_ae(ae: nn.Module, images: np.ndarray, *, epochs: int = 20,
           batch_size: int = 8, lr: float = 1e-4, kl_weight: float = 1e-6,
           seed: int = 0, log=print):
    """Train the first-stage VAE on domain images, in place, from a fresh
    initialisation drawn from ``seed`` (as the JAX package draws fresh
    parameters from its seed). images: [N, H, W, 3] float in [-1, 1],
    fed in batches of ``batch_size`` with the last partial batch dropped.
    Returns ``(LdmTrainState, history)``, history holding each epoch's
    mean ``{"loss", "rec", "kl"}``."""
    n = int(images.shape[0])
    if n < batch_size:
        raise ValueError(f"need >= batch_size={batch_size} images, got {n}")
    dev = _device_of(ae)
    devices = [dev] if dev.type == "cuda" else []
    with torch.random.fork_rng(devices=devices):
        torch.manual_seed(seed)
        for mod in ae.modules():
            if hasattr(mod, "reset_parameters"):
                mod.reset_parameters()
    opt = adam(ae.parameters(), lr)
    step = make_ae_train_step(ae, opt, kl_weight=kl_weight)
    rng = np.random.RandomState(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    history, steps = [], 0
    for ep in range(epochs):
        outs = []
        for idx in _batches(n, batch_size, rng):
            batch = torch.as_tensor(np.asarray(images[idx], np.float32),
                                    device=dev)
            outs.append(torch.stack(step(batch, gen)))
            steps += 1
        loss, rec, kl = torch.stack(outs).mean(0).tolist()
        history.append({"loss": loss, "rec": rec, "kl": kl})
        log(f"[train_ae] epoch {ep + 1}/{epochs} loss {loss:.4f} "
            f"rec {rec:.4f} kl {kl:.1f}")
    return LdmTrainState(ae, opt, steps), history
