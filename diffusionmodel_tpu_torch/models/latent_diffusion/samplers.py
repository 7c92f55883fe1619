"""DDIM / DPM-Solver++(2M) / DDPM samplers for latent diffusion
(counterpart of ``diffusionmodel_tpu/models/latent_diffusion/samplers.py``).

Classifier-free guidance in the standard orientation,
``eps = e_uncond + scale · (e_cond − e_uncond)``, through one doubled batch.
A conditioning is a context tensor, or a (context, y) pair (SDXL), whose
members are doubled alike.
The JAX package's ``lax.scan`` loops are Python loops here. Per-step
coefficients are computed once on the host in fp32 numpy (the JAX package
computes the same fp32 expressions on the device) and applied as Python
floats, which torch applies in fp32.

Every random draw can be injected so tests can hand both packages the same
noise: ``x_last`` (x_T), ``noise_fn(index)`` (the per-step z of DDIM with
eta > 0 and of DDPM), the q_sample noise and inpainting's ``orig_noise``.
Without them draws come from ``generator``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from diffusionmodel_tpu_torch import tracing
from diffusionmodel_tpu_torch.diffusion import dpmpp_terms

NoiseFn = Callable[[int], object]


def map_cond(fn, *conds):
    """``fn`` over conditionings: of the context tensors, or of each member
    of (context, y) pairs in turn (a pair out)."""
    if isinstance(conds[0], tuple):
        return tuple(fn(*parts) for parts in zip(*conds))
    return fn(*conds)


def _device(cond) -> torch.device:
    return (cond[0] if isinstance(cond, tuple) else cond).device


def _cat(a, b):
    return torch.cat([a, b])


def cfg_eps(eps_fn, x, t, cond, uncond, scale):
    """Doubled-batch classifier-free guidance (standard orientation)."""
    if uncond is None or scale == 1.0:
        return eps_fn(x, t, cond)
    e = eps_fn(torch.cat([x, x]), torch.cat([t, t]),
               map_cond(_cat, uncond, cond))
    e_uncond, e_cond = e.chunk(2)
    return e_uncond + scale * (e_cond - e_uncond)


def ldm_time_steps(T: int, n_steps: int, discretize: str = "uniform"
                   ) -> np.ndarray:
    """The visited taus, ascending: the reference construction truncated to
    ``n_steps`` and clamped into [.., T-1] (as the JAX package does)."""
    if discretize == "uniform":
        c = T // n_steps
        return np.minimum(np.asarray(list(range(0, T, c))[:n_steps]) + 1,
                          T - 1)
    if discretize == "quad":
        return np.minimum(((np.linspace(0, np.sqrt(T * 0.8), n_steps)) ** 2
                           ).astype(int) + 1, T - 1)
    raise ValueError(discretize)


def _noise(noise_fn: Optional[NoiseFn], index: int, shape, generator,
           device) -> torch.Tensor:
    if noise_fn is not None:
        return torch.as_tensor(noise_fn(index), dtype=torch.float32,
                               device=device)
    return torch.randn(shape, generator=generator, device=device)


def _start(x_last, shape, generator, device) -> torch.Tensor:
    if x_last is not None:
        return torch.as_tensor(x_last, dtype=torch.float32, device=device)
    return torch.randn(shape, generator=generator, device=device)


def _steps(n: int, tau: int, device) -> torch.Tensor:
    return torch.full((n,), int(tau), dtype=torch.int64, device=device)


class DDIMSampler:
    def __init__(self, model, n_steps: int = 50, ddim_eta: float = 0.0,
                 discretize: str = "uniform"):
        self.model = model
        self.time_steps = ldm_time_steps(model.n_steps, n_steps, discretize)
        ab = model.sched.alpha_bar.cpu().numpy()
        one = np.float32(1.0)
        self.alpha = ab[self.time_steps]
        self.alpha_prev = np.concatenate(
            [ab[:1], ab[self.time_steps[:-1]]]).astype(np.float32)
        self.sigma = (np.float32(ddim_eta) * np.sqrt(
            (one - self.alpha_prev) / (one - self.alpha)
            * (one - self.alpha / self.alpha_prev))).astype(np.float32)
        self.sqrt_one_minus_alpha = np.sqrt(one - self.alpha)
        self.sqrt_alpha = np.sqrt(self.alpha)
        self.sqrt_alpha_prev = np.sqrt(self.alpha_prev)
        self.dir_coef = np.sqrt(one - self.alpha_prev - self.sigma ** 2)
        self.n_steps = len(self.time_steps)

    def get_x_prev_and_pred_x0(self, eps, index: int, x,
                               temperature: float = 1.0, noise=None):
        """One DDIM update. ``noise`` (standard normal, x's shape) is used
        only where sigma > 0."""
        pred_x0 = (x - float(self.sqrt_one_minus_alpha[index]) * eps) \
            / float(self.sqrt_alpha[index])
        x_prev = float(self.sqrt_alpha_prev[index]) * pred_x0 \
            + float(self.dir_coef[index]) * eps
        if self.sigma[index] > 0:
            x_prev = x_prev + float(self.sigma[index]) * (noise * temperature)
        return x_prev, pred_x0

    def _step(self, x, index, cond, uncond_scale, uncond_cond, temperature,
              generator, noise_fn, repeat_noise=False):
        with tracing.span("sample.step"):
            t = _steps(x.shape[0], self.time_steps[index], x.device)
            eps = cfg_eps(self.model.eps_fn, x, t, cond, uncond_cond,
                          uncond_scale)
            noise = None
            if self.sigma[index] > 0:
                shape = ((1,) + tuple(x.shape[1:]) if repeat_noise
                         else x.shape)
                noise = _noise(noise_fn, index, shape, generator, x.device)
            return self.get_x_prev_and_pred_x0(eps, index, x, temperature,
                                               noise)[0]

    @torch.inference_mode()
    def sample(self, shape, cond, generator=None, repeat_noise: bool = False,
               temperature: float = 1.0, x_last=None,
               uncond_scale: float = 1.0, uncond_cond=None,
               skip_steps: int = 0, noise_fn: Optional[NoiseFn] = None):
        x = _start(x_last, shape, generator, _device(cond))
        for index in range(self.n_steps - 1 - skip_steps, -1, -1):
            x = self._step(x, index, cond, uncond_scale, uncond_cond,
                           temperature, generator, noise_fn, repeat_noise)
        return x

    def q_sample(self, x0, index: int, generator=None, noise=None):
        if noise is None:
            noise = torch.randn(x0.shape, generator=generator,
                                device=x0.device)
        else:
            noise = torch.as_tensor(noise, dtype=torch.float32,
                                    device=x0.device)
        return float(self.sqrt_alpha[index]) * x0 \
            + float(self.sqrt_one_minus_alpha[index]) * noise

    @torch.inference_mode()
    def paint(self, x, cond, t_start: int, orig=None, mask=None,
              orig_noise=None, uncond_scale: float = 1.0, uncond_cond=None,
              generator=None, noise_fn: Optional[NoiseFn] = None):
        """img2img / inpaint loop: denoise from ``t_start``; with ``mask``,
        keep ``orig`` (re-noised to the step) where mask = 1."""
        for index in range(t_start - 1, -1, -1):
            x = self._step(x, index, cond, uncond_scale, uncond_cond, 1.0,
                           generator, noise_fn)
            if orig is not None and mask is not None:
                noise = orig_noise if orig_noise is not None else \
                    torch.randn(x.shape, generator=generator, device=x.device)
                orig_t = float(self.sqrt_alpha[index]) * orig \
                    + float(self.sqrt_one_minus_alpha[index]) * noise
                x = orig_t * mask + x * (1.0 - mask)
        return x


class DPMPPSampler:
    """DPM-Solver++(2M) on the LDM schedule: deterministic given x_T; the
    per-step terms come from the port's ``diffusion.dpmpp_terms``
    (float64 on the host, returned in fp32)."""

    def __init__(self, model, n_steps: int = 25, discretize: str = "uniform"):
        self.model = model
        taus = ldm_time_steps(model.n_steps, n_steps, discretize)[::-1]
        ab = model.sched.alpha_bar.cpu().numpy().astype(np.float64)
        a_nxt = np.concatenate([ab[taus[1:]], np.ones(1)])
        self.time_steps = taus.copy()
        self.n_steps = len(taus)
        self.terms = dpmpp_terms(ab[taus], a_nxt)

    @torch.inference_mode()
    def sample(self, shape, cond, generator=None, x_last=None,
               uncond_scale: float = 1.0, uncond_cond=None):
        x = _start(x_last, shape, generator, _device(cond))
        x0_prev = torch.zeros_like(x)
        for k, tau in enumerate(self.time_steps):
            with tracing.span("sample.step"):
                ac, sc, an, rt, e1m, i2r = (float(v[k]) for v in self.terms)
                eps = cfg_eps(self.model.eps_fn, x,
                              _steps(x.shape[0], tau, x.device),
                              cond, uncond_cond, uncond_scale)
                x0 = (x - sc * eps) / ac
                d = (1.0 + i2r) * x0 - i2r * x0_prev
                x = rt * x - (an * e1m) * d
                x0_prev = x0
        return x


class DDPMSampler:
    """Ancestral sampler over all T steps with the x0-parameterised
    posterior; ``skip_steps`` starts it that many steps late."""

    def __init__(self, model):
        self.model = model
        s = model.sched
        ab = s.alpha_bar.cpu().numpy()
        beta = s.beta.cpu().numpy()
        one = np.float32(1.0)
        ab_prev = np.concatenate([np.ones(1, np.float32), ab[:-1]])
        self.n_steps = model.n_steps
        self.sqrt_recip_ab = np.sqrt(one / ab)
        self.sqrt_recip_m1_ab = np.sqrt(one / ab - one)
        variance = beta * (one - ab_prev) / (one - ab)
        self.log_var = np.log(np.clip(variance, np.float32(1e-20), None))
        self.std = np.exp(np.float32(0.5) * self.log_var)
        self.mean_x0_coef = beta * np.sqrt(ab_prev) / (one - ab)
        self.mean_xt_coef = (one - ab_prev) * np.sqrt(one - beta) / (one - ab)

    @torch.inference_mode()
    def sample(self, shape, cond, generator=None, temperature: float = 1.0,
               x_last=None, uncond_scale: float = 1.0, uncond_cond=None,
               skip_steps: int = 0, noise_fn: Optional[NoiseFn] = None):
        x = _start(x_last, shape, generator, _device(cond))
        for t in range(self.n_steps - 1 - skip_steps, -1, -1):
            with tracing.span("sample.step"):
                eps = cfg_eps(self.model.eps_fn, x,
                              _steps(x.shape[0], t, x.device),
                              cond, uncond_cond, uncond_scale)
                x0 = float(self.sqrt_recip_ab[t]) * x \
                    - float(self.sqrt_recip_m1_ab[t]) * eps
                x = float(self.mean_x0_coef[t]) * x0 \
                    + float(self.mean_xt_coef[t]) * x
                if t > 0:
                    z = _noise(noise_fn, t, x.shape, generator, x.device)
                    x = x + float(self.std[t]) * (z * temperature)
        return x
