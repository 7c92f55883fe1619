"""txt2img / img2img / inpaint pipelines (counterpart of
``diffusionmodel_tpu/models/latent_diffusion/pipelines.py``).

Each pipeline takes a ``LatentDiffusion`` and conditioning arrays
([B, 77, d_cond], or (context, y) pairs for SDXL); without ``uncond`` the
unconditional embedding is zeros, as in the JAX package when no text
embedder is given. Random draws come from ``generator`` unless injected
(``x_last``, ``encode_noise``, ``q_noise``, ``orig_noise``,
``noise_fn``), which the parity tests use.
"""

from __future__ import annotations

from typing import Optional

import torch

from diffusionmodel_tpu_torch import tracing
from diffusionmodel_tpu_torch.models.latent_diffusion.samplers import (
    DDIMSampler,
    DDPMSampler,
    DPMPPSampler,
    map_cond,
)


def make_sampler(model, sampler_name: str, n_steps: int, ddim_eta: float):
    if sampler_name == "ddim":
        return DDIMSampler(model, n_steps=n_steps, ddim_eta=ddim_eta)
    if sampler_name == "ddpm":
        return DDPMSampler(model)
    if sampler_name == "dpmpp":
        return DPMPPSampler(model, n_steps=n_steps)
    raise ValueError(sampler_name)


def _as(x, model):
    return None if x is None else torch.as_tensor(
        x, dtype=torch.float32, device=model.device)


def _conds(model, cond, uncond):
    cond = map_cond(lambda c: _as(c, model), cond)
    if uncond is None:
        return cond, map_cond(torch.zeros_like, cond)
    return cond, map_cond(lambda c: _as(c, model), uncond)


class Txt2Img:
    """cond/uncond -> sampler -> VAE decode (with ``tracing`` on, the spans
    ``ldm.sample``, with a ``sample.step`` a step, and ``ldm.decode``)."""

    def __init__(self, model, sampler: str = "ddim", n_steps: int = 50,
                 ddim_eta: float = 0.0):
        self.model = model
        self.sampler = make_sampler(model, sampler, n_steps, ddim_eta)

    @torch.inference_mode()
    def __call__(self, cond, batch_size: int = 1, h: int = 512, w: int = 512,
                 uncond_scale: float = 7.5, uncond=None,
                 generator: Optional[torch.Generator] = None, x_last=None,
                 noise_fn=None, skip_steps: int = 0):
        """``skip_steps`` (DDIM and DDPM only) starts the sampler that many
        steps late, from ``x_last`` or fresh noise."""
        if h % 32 or w % 32:
            raise ValueError(f"h and w must be multiples of 32, got {h}x{w}")
        cond, uncond = _conds(self.model, cond, uncond)
        kw = {}
        if skip_steps:
            if isinstance(self.sampler, DPMPPSampler):
                raise ValueError("skip_steps is not defined for dpmpp")
            kw["skip_steps"] = skip_steps
        if noise_fn is not None:
            kw["noise_fn"] = noise_fn
        with tracing.span("ldm.sample"):
            x = self.sampler.sample((batch_size, h // 8, w // 8, 4), cond,
                                    generator=generator, x_last=x_last,
                                    uncond_scale=uncond_scale,
                                    uncond_cond=uncond, **kw)
        with tracing.span("ldm.decode", images=batch_size):
            return self.model.autoencoder_decode(x)


class Img2Img:
    """encode orig -> q_sample at strength·steps -> paint -> decode."""

    def __init__(self, model, n_steps: int = 50, ddim_eta: float = 0.0):
        self.model = model
        self.sampler = DDIMSampler(model, n_steps=n_steps, ddim_eta=ddim_eta)

    @torch.inference_mode()
    def __call__(self, orig_img, cond, strength: float = 0.75,
                 uncond_scale: float = 5.0, uncond=None,
                 generator: Optional[torch.Generator] = None,
                 encode_noise=None, q_noise=None, noise_fn=None):
        cond, uncond = _conds(self.model, cond, uncond)
        z = self.model.autoencoder_encode(_as(orig_img, self.model),
                                          generator, encode_noise)
        t_index = int(strength * self.sampler.n_steps)
        xt = self.sampler.q_sample(z, t_index - 1, generator, q_noise)
        x = self.sampler.paint(xt, cond, t_index, uncond_scale=uncond_scale,
                               uncond_cond=uncond, generator=generator,
                               noise_fn=noise_fn)
        return self.model.autoencoder_decode(x)


class InPaint:
    """img2img with a keep-mask (1 = keep the original latent) and the
    original re-noised at each step; the default mask keeps the bottom
    half."""

    def __init__(self, model, n_steps: int = 50, ddim_eta: float = 0.0):
        self.model = model
        self.sampler = DDIMSampler(model, n_steps=n_steps, ddim_eta=ddim_eta)

    @torch.inference_mode()
    def __call__(self, orig_img, cond, mask=None, strength: float = 0.75,
                 uncond_scale: float = 5.0, uncond=None,
                 generator: Optional[torch.Generator] = None,
                 encode_noise=None, orig_noise=None, q_noise=None,
                 noise_fn=None):
        cond, uncond = _conds(self.model, cond, uncond)
        z = self.model.autoencoder_encode(_as(orig_img, self.model),
                                          generator, encode_noise)
        if mask is None:
            mask = torch.zeros_like(z)
            mask[:, z.shape[1] // 2:] = 1.0  # preserve the bottom half
        mask = _as(mask, self.model)
        if orig_noise is None:
            orig_noise = torch.randn(z.shape, generator=generator,
                                     device=z.device)
        t_index = int(strength * self.sampler.n_steps)
        xt = self.sampler.q_sample(z, t_index - 1, generator, q_noise)
        x = self.sampler.paint(xt, cond, t_index, orig=z, mask=mask,
                               orig_noise=_as(orig_noise, self.model),
                               uncond_scale=uncond_scale, uncond_cond=uncond,
                               generator=generator, noise_fn=noise_fn)
        return self.model.autoencoder_decode(x)
