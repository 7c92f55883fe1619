"""Textbook DDPM process (the vendored labml formulation,
reference/ddpm/__init__.py:172-287), counterpart of
``diffusionmodel_tpu/models/annotated_ddpm/diffusion.py``.

Schedule: ``beta = linspace(1e-4, 0.02, T)`` in float32 as ``jnp.linspace``
forms it (``start * (1 - i/(T-1)) + stop * i/(T-1)``), ``abar =
cumprod(1 - beta)``, t in [0, T): not the main family's 1..T. Also the
evaluate.py capabilities (reference/ddpm/evaluate.py): x0-tracking
trajectories, two-image interpolation, the p_x0 estimator.

Noise: every draw comes from a ``torch.Generator`` or is handed in
(``eps``, ``z``, ``noise_fn(t)``), which is how the tests give the port the
JAX package's ``jax.random`` draws. ``slot_seeds`` pins per-slot streams
(``diffusion._slot_normal``), as the service needs.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from diffusionmodel_tpu_torch.device_check import resolve_device
from diffusionmodel_tpu_torch.diffusion import _slot_normal

NoiseFn = Callable[[int], torch.Tensor]


class TextbookSchedule(NamedTuple):
    beta: torch.Tensor       # [T]
    alpha: torch.Tensor      # [T]
    alpha_bar: torch.Tensor  # [T]
    sigma2: torch.Tensor     # [T] (= beta)

    @property
    def device(self) -> torch.device:
        return self.beta.device


def textbook_schedule(T: int = 1000, beta1: float = 1e-4, beta2: float = 0.02,
                      device: Optional[Union[str, torch.device]] = None
                      ) -> TextbookSchedule:
    """On ``device``: CUDA by default, raising when it is absent."""
    dev = resolve_device(device)
    f32 = torch.float32
    step = torch.arange(T - 1, dtype=f32) / torch.tensor(T - 1, dtype=f32)
    start, stop = torch.tensor(beta1, dtype=f32), torch.tensor(beta2, dtype=f32)
    beta = torch.cat([start * (1 - step) + stop * step, stop[None]]).to(dev)
    alpha = 1.0 - beta
    return TextbookSchedule(beta, alpha, torch.cumprod(alpha, dim=0), beta)


def _col(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(-1, 1, 1, 1)


class DenoiseDiffusion:
    """eps-prediction diffusion over a :class:`TextbookSchedule`;
    ``eps_fn(x_t, t)`` with ``t`` [B] integer timesteps."""

    def __init__(self, eps_fn: Callable[[torch.Tensor, torch.Tensor],
                                        torch.Tensor],
                 n_steps: int = 1000, beta1: float = 1e-4,
                 beta2: float = 0.02,
                 device: Optional[Union[str, torch.device]] = None):
        self.eps_fn = eps_fn
        self.n_steps = n_steps
        self.sched = textbook_schedule(n_steps, beta1, beta2, device)

    @property
    def device(self) -> torch.device:
        return self.sched.device

    def _t(self, t) -> torch.Tensor:
        return torch.as_tensor(t, device=self.device).to(torch.int64)

    def q_xt_x0(self, x0, t) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mean and variance of q(x_t | x_0)."""
        ab = _col(self.sched.alpha_bar[self._t(t)])
        return torch.sqrt(ab) * x0, 1.0 - ab

    def q_sample(self, x0, t, eps) -> torch.Tensor:
        mean, var = self.q_xt_x0(x0, t)
        return mean + torch.sqrt(var) * eps

    def _step(self, xt, t: torch.Tensor, eps_theta, z) -> torch.Tensor:
        ab = _col(self.sched.alpha_bar[t])
        a = _col(self.sched.alpha[t])
        mean = (xt - (1.0 - a) / torch.sqrt(1.0 - ab) * eps_theta) \
            / torch.sqrt(a)
        z = torch.where(_col(t) > 0, z, torch.zeros_like(z))
        return mean + torch.sqrt(_col(self.sched.sigma2[t])) * z

    def p_sample_step(self, xt, t, generator: Optional[torch.Generator] = None,
                      z=None) -> torch.Tensor:
        """One reverse step x_t -> x_{t-1} (reference/ddpm/__init__.py:
        230-255); ``z`` is drawn from ``generator`` unless given."""
        t = self._t(t)
        eps_theta = self.eps_fn(xt, t).float()
        if z is None:
            z = torch.randn(xt.shape, generator=generator, device=xt.device)
        return self._step(xt, t, eps_theta, torch.as_tensor(z).to(xt))

    def p_x0(self, xt, t, eps) -> torch.Tensor:
        """x0 estimate from (x_t, eps) (reference/ddpm/evaluate.py:239-250)."""
        ab = _col(self.sched.alpha_bar[self._t(t)])
        return (xt - torch.sqrt(1.0 - ab) * eps) / torch.sqrt(ab)

    def loss(self, x0, generator: Optional[torch.Generator] = None, t=None,
             eps=None) -> torch.Tensor:
        """MSE(eps, eps_theta) with t ~ U[0, T) (drawn unless given)."""
        b = x0.shape[0]
        if t is None:
            t = torch.randint(0, self.n_steps, (b,), generator=generator,
                              device=self.device)
        if eps is None:
            eps = torch.randn(x0.shape, generator=generator,
                              device=self.device)
        t = self._t(t)
        eps = torch.as_tensor(eps, dtype=torch.float32).to(self.device)
        xt = self.q_sample(x0, t, eps)
        return torch.mean((eps - self.eps_fn(xt, t).float()) ** 2)

    @torch.inference_mode()
    def sample(self, generator: Optional[torch.Generator], n: int,
               img_shape: Tuple[int, int, int], track_x0: bool = False,
               steps: Optional[Sequence[int]] = None, x_init=None,
               slot_seeds=None, noise_fn: Optional[NoiseFn] = None):
        """The reverse process over the descending ``steps`` (default
        T-1..0; t = -1 entries are no-op padding, as in the JAX package's
        chunked runs). With ``track_x0`` also returns the per-step x0
        estimates [len(steps), n, H, W, C] (reference/ddpm/evaluate.py:
        90-129). Per-step noise: ``noise_fn(t)``, else per-slot streams
        from ``slot_seeds``, else ``generator``."""
        dev = self.device
        x = (torch.as_tensor(x_init, dtype=torch.float32).to(dev)
             if x_init is not None
             else torch.randn((n, *img_shape), generator=generator,
                              device=dev))
        if steps is None:
            steps = range(self.n_steps - 1, -1, -1)
        x0s = []
        for t in (int(s) for s in steps):
            tb = torch.full((n,), max(t, 0), dtype=torch.int64, device=dev)
            if t < 0 and not track_x0:
                continue
            eps = self.eps_fn(x, tb).float()
            if track_x0:
                x0s.append(self.p_x0(x, tb, eps))
            if t < 0:
                continue
            if noise_fn is not None:
                z = noise_fn(t).to(device=dev, dtype=torch.float32)
            elif slot_seeds is not None:
                z = _slot_normal(slot_seeds, t, tuple(img_shape), dev)
            elif t > 0:
                z = torch.randn(x.shape, generator=generator, device=dev)
            else:
                z = torch.zeros_like(x)
            x = self._step(x, tb, eps, z)
        return (x, torch.stack(x0s)) if track_x0 else x

    @torch.inference_mode()
    def interpolate(self, x1, x2, lam: float = 0.5, t_: Optional[int] = None,
                    generator: Optional[torch.Generator] = None,
                    noise1=None, noise2=None,
                    noise_fn: Optional[NoiseFn] = None) -> torch.Tensor:
        """Two-image interpolation (reference/ddpm/evaluate.py:131-166):
        q-sample both at t_, mix with ``lam``, denoise from t_."""
        t_ = self.n_steps - 1 if t_ is None else t_
        dev = self.device
        x1 = torch.as_tensor(x1, dtype=torch.float32).to(dev)
        x2 = torch.as_tensor(x2, dtype=torch.float32).to(dev)
        n = x1.shape[0]
        if noise1 is None:
            noise1 = torch.randn(x1.shape, generator=generator, device=dev)
        if noise2 is None:
            noise2 = torch.randn(x2.shape, generator=generator, device=dev)
        tb = torch.full((n,), t_, dtype=torch.int64, device=dev)
        x = (1 - lam) * self.q_sample(x1, tb, torch.as_tensor(noise1).to(x1)) \
            + lam * self.q_sample(x2, tb, torch.as_tensor(noise2).to(x2))
        for t in range(t_, -1, -1):
            z = (noise_fn(t).to(x) if noise_fn is not None else None)
            x = self.p_sample_step(x, torch.full((n,), t, device=dev),
                                   generator, z=z)
        return x


def make_textbook_chunk_fn(model, dc, n_sample: int, img_shape):
    """The textbook family's sampling adapter, shared by
    ``trainer.make_sampler`` and ``serving.SamplerService`` (the eps-fn
    call convention is the annotated-DDPM contract): returns
    ``chunk_fn(x, generator, steps, slot_seeds=None, noise_fn=None)``,
    the ancestral ``sample`` over ``steps`` (T-1..0, padded with -1:
    :func:`textbook_chunk_steps`) from ``x``. The denoiser gets zero class
    ids, float timesteps, a zero context mask and no attention mask."""
    dev = next(model.parameters()).device
    dd = DenoiseDiffusion(None, dc.n_T, dc.beta1, dc.beta2, dev)

    def eps_fn(xx, tt):
        nb = xx.shape[0]
        return model(xx, torch.zeros(nb, dtype=torch.int64, device=dev),
                     tt.to(torch.float32), torch.zeros(nb, device=dev), None)

    dd.eps_fn = eps_fn

    def chunk_fn(x, generator, steps, slot_seeds=None, noise_fn=None):
        return dd.sample(generator, n_sample, img_shape, steps=steps,
                         x_init=x, slot_seeds=slot_seeds, noise_fn=noise_fn)

    return chunk_fn


def textbook_chunk_steps(n_T: int) -> np.ndarray:
    """The textbook family's step sequence: t counts n_T-1 down to 0
    (t in [0, T), unlike the main family's 1..T)."""
    return np.arange(n_T - 1, -1, -1, dtype=np.int32)
