"""The main family's diffusion process (counterpart of
``diffusionmodel_tpu/diffusion.py``): ``q_sample``, the training loss
(with the textbook family's branch), the classifier-free-guided samplers
(ancestral, DDIM, DPM-Solver++(2M)) and image editing (img2img / inpaint
over DDIM, ``sample_cfg_edit``).

The loss (``train_loss``) is fp32 whatever the network computes in. Its
draws (t, eps, the context mask) come from a ``torch.Generator`` in that
order, or are handed in, which is how the tests give the port the JAX
package's own ``jax.random`` draws. Images are [B,H,W,C] and masks
[B,H,W], the JAX layout (the ContextUnet's public layout too), and every
mean is over all elements, so no value depends on memory layout.

Each step evaluates the conditional and unconditional branches in one
network call on the doubled batch; the JAX package's ``lax.scan`` becomes
a Python loop, the network runs eagerly. All sampler arithmetic is fp32
on the device, with the same per-step scalars as the JAX package (fp32
tensors, never Python doubles, so the roundings match).

Quirk Q1: the v2.0 sampler computes ``eps = (1+w)*eps(uncond) - w*eps(cond)``
(first half mask 0, second half mask 1); ``cfg_fixed_orientation=True``
swaps the halves. Q3: no spatial mask exists while sampling, so the
LocalEnhancer is the identity.

``eps_fn(x, c, t_norm, ctx_mask)`` is the denoiser in eval mode (a
``ContextUnet`` is one). Noise: ``x_init`` pins the start noise; the
per-step noise of the stochastic samplers comes from ``noise_fn(step)``
when given (tests inject the JAX package's draws through it), else from
per-slot generators seeded by ``slot_seeds``, else from ``generator``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from diffusionmodel_tpu_torch.config import DiffusionConfig
from diffusionmodel_tpu_torch.schedules import ddpm_schedules

EpsFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
                 torch.Tensor]
NoiseFn = Callable[[int], torch.Tensor]


class Schedule(NamedTuple):
    """The 7 precomputed buffers, each [T+1] float32, on one device."""

    alpha_t: torch.Tensor
    oneover_sqrta: torch.Tensor
    sqrt_beta_t: torch.Tensor
    alphabar_t: torch.Tensor
    sqrtab: torch.Tensor
    sqrtmab: torch.Tensor
    mab_over_sqrtmab: torch.Tensor

    @classmethod
    def create(cls, beta1: float, beta2: float, n_T: int,
               device: Optional[Union[str, torch.device]] = None
               ) -> "Schedule":
        """On ``device``: CUDA by default, raising when it is absent."""
        return cls(**ddpm_schedules(beta1, beta2, n_T, device))

    @property
    def device(self) -> torch.device:
        return self.alpha_t.device


def _guide_arr(guide_w, n_sample: int, device: torch.device) -> torch.Tensor:
    """A scalar stays 0-dim; a [n] vector (per-sample guidance) becomes
    [n,1,1,1]."""
    w = torch.as_tensor(guide_w, dtype=torch.float32, device=device)
    if w.dim() == 0:
        return w
    if tuple(w.shape) != (n_sample,):
        raise ValueError(f"guide_w must be a scalar or shape ({n_sample},), "
                         f"got {tuple(w.shape)}")
    return w.reshape(n_sample, 1, 1, 1)


def _cfg_inputs(n_sample: int, n_classes: int, dc: DiffusionConfig,
                classes, device: torch.device):
    if classes is None:
        c = torch.arange(n_sample, device=device, dtype=torch.int64) % n_classes
    else:
        c = torch.as_tensor(classes, device=device).to(torch.int64)
    c2 = torch.cat([c, c])
    first = 1.0 if dc.cfg_fixed_orientation else 0.0
    mask2 = torch.cat([torch.full((n_sample,), first),
                       torch.full((n_sample,), 1.0 - first)]).to(
        device=device, dtype=torch.float32)
    return c2, mask2


def _slot_normal(slot_seeds: Sequence[int], step: int, img_shape,
                 device: torch.device) -> torch.Tensor:
    """Per-slot Gaussian noise for ``step`` from each slot's own seed, so a
    seed-pinned request reproduces its run-alone images under the
    stochastic samplers whatever shares its batch. (The draws differ from
    the JAX package's threefry ones; tests inject those via ``noise_fn``.)"""
    out = []
    for s in slot_seeds:
        # a generator seed that depends on (slot seed, absolute step) only
        seed = np.random.SeedSequence([int(s), int(step)]).generate_state(
            1, np.uint64)[0]
        g = torch.Generator(device=device).manual_seed(int(seed))
        out.append(torch.randn(tuple(img_shape), generator=g, device=device))
    return torch.stack(out)


def _step_noise(step: int, x: torch.Tensor, noise_fn: Optional[NoiseFn],
                slot_seeds, generator: Optional[torch.Generator]
                ) -> torch.Tensor:
    if noise_fn is not None:
        return noise_fn(step).to(device=x.device, dtype=torch.float32)
    if slot_seeds is not None:
        return _slot_normal(slot_seeds, step, x.shape[1:], x.device)
    return torch.randn(x.shape, generator=generator, device=x.device)


def _start_noise(x_init, n_sample, img_shape, generator, device):
    if x_init is not None:
        return torch.as_tensor(x_init, dtype=torch.float32).to(device)
    h, w, ch = img_shape
    return torch.randn((n_sample, h, w, ch), generator=generator,
                       device=device)


def _cfg_eps(eps_fn: EpsFn, x, c2, mask2, t_int: int, n_T: int, gw):
    n = x.shape[0]
    t_norm = torch.full((2 * n,), float(t_int), device=x.device) / n_T
    eps = eps_fn(torch.cat([x, x]), c2, t_norm, mask2).float()
    e1, e2 = eps[:n], eps[n:]
    return (1.0 + gw) * e1 - gw * e2


def q_sample(sched: Schedule, x0: torch.Tensor, ts: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """x_t = sqrt(abar_t) x_0 + sqrt(1-abar_t) eps (new_scripy.py:408-411)."""
    sab = sched.sqrtab[ts][:, None, None, None]
    smab = sched.sqrtmab[ts][:, None, None, None]
    return sab * x0 + smab * noise


def loss_weights(attn_mask: torch.Tensor, dc: DiffusionConfig) -> torch.Tensor:
    """Per-pixel MSE weights from the attention mask (new_scripy.py:420-424)."""
    mid = torch.where(attn_mask > dc.mid_thresh,
                      torch.tensor(dc.mid_weight, dtype=torch.float32),
                      torch.tensor(dc.low_weight, dtype=torch.float32))
    return torch.where(attn_mask > dc.high_thresh,
                       torch.tensor(dc.high_weight, dtype=torch.float32),
                       mid).float()


def train_loss(apply_fn: Callable, x: torch.Tensor, c: torch.Tensor,
               attn_mask: Optional[torch.Tensor], sched: Schedule,
               dc: DiffusionConfig, *, ts=None, noise=None, ctx_mask=None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Training objective (new_scripy.py:401-439).

    ``apply_fn(x_t, c, t_norm, ctx_mask, attn_mask) -> eps_pred``.

    - t ~ U[1, n_T]; eps ~ N(0,1); x_t = q_sample.
    - ctx_mask ~ Bernoulli(1 - drop_prob) (1 = keep context).
    - weighted MSE (weights 3.0/1.0/0.5 by mask thresholds 1.2/0.8) +
      feat_consist_weight * mean(|eps_pred - eps| * [mask > high_thresh]).
    - use_weighted_loss=False => plain MSE (MNIST_script.py:252; there the
      Bernoulli drop mask has p = drop_prob with 1 = DROP, matching the
      network-side mnist_style_ctx_flip).

    ``ts`` [B] int, ``noise`` like x and ``ctx_mask`` [B] are drawn from
    ``generator`` on x's device unless given (arrays or tensors).

    ``schedule_family="textbook"`` is the labml formulation
    (reference/ddpm/__init__.py:257-287): t ~ U[0, n_T), ``sched`` a
    ``TextbookSchedule`` (abar = cumprod(1 - linspace beta)), plain MSE,
    the raw timestep to the network and a zero context mask (the family
    is unconditional); ``ctx_mask`` is not drawn."""
    b, dev = x.shape[0], x.device
    x = x.to(torch.float32)
    if dc.schedule_family == "textbook":
        if ts is None:
            ts = torch.randint(0, dc.n_T, (b,), generator=generator,
                               device=dev)
        ts = torch.as_tensor(ts, device=dev).to(torch.int64)
        if noise is None:
            noise = torch.randn(x.shape, generator=generator, device=dev)
        noise = torch.as_tensor(noise, dtype=torch.float32).to(dev)
        ab = sched.alpha_bar[ts][:, None, None, None]
        x_t = torch.sqrt(ab) * x + torch.sqrt(1.0 - ab) * noise
        eps_pred = apply_fn(x_t, c, ts.to(torch.float32),
                            torch.zeros(b, device=dev), None).float()
        return torch.mean((noise - eps_pred) ** 2)
    if ts is None:
        ts = torch.randint(1, dc.n_T + 1, (b,), generator=generator,
                           device=dev)
    ts = torch.as_tensor(ts, device=dev).to(torch.int64)
    if noise is None:
        noise = torch.randn(x.shape, generator=generator, device=dev)
    noise = torch.as_tensor(noise, dtype=torch.float32).to(dev)
    x_t = q_sample(sched, x, ts, noise)
    if ctx_mask is None:
        # v2: keep-mask, 1 = keep (new_scripy.py:413); MNIST: drop-mask,
        # 1 = drop (MNIST_script.py:249).
        p_one = 1.0 - dc.drop_prob if dc.use_weighted_loss else dc.drop_prob
        ctx_mask = torch.rand(b, generator=generator, device=dev) < p_one
    ctx_mask = torch.as_tensor(ctx_mask, device=dev).to(torch.float32)

    t_norm = ts.to(torch.float32) / dc.n_T
    pass_mask = attn_mask if dc.local_enhancer_spatial_mask else None
    eps_pred = apply_fn(x_t, c, t_norm, ctx_mask, pass_mask).float()

    if not dc.use_weighted_loss or attn_mask is None:
        return torch.mean((noise - eps_pred) ** 2)

    attn_mask = attn_mask.to(torch.float32)
    w = loss_weights(attn_mask, dc).to(dev)[..., None]  # broadcast over C
    weighted = torch.mean((noise - eps_pred) ** 2 * w)
    high = (attn_mask > dc.high_thresh).to(torch.float32)[..., None]
    feat_consist = (torch.mean(torch.abs(eps_pred * high - noise * high))
                    * dc.feat_consist_weight)
    return weighted + feat_consist


@torch.inference_mode()
def sample_cfg(eps_fn: EpsFn, generator: Optional[torch.Generator],
               n_sample: int, img_shape: Tuple[int, int, int], n_classes: int,
               sched: Schedule, dc: DiffusionConfig, guide_w=0.0,
               classes=None, steps: Optional[Sequence[int]] = None,
               x_init=None, slot_seeds=None,
               noise_fn: Optional[NoiseFn] = None,
               return_history: bool = False):
    """Ancestral CFG sampling (new_scripy.py:441-477) over the descending
    ``steps`` (default n_T..1; entries < 1 are no-op padding, as in the
    JAX package's chunked runs). Returns x_0 [n_sample, H, W, C], and with
    ``return_history`` also the trajectory [len(steps), n_sample, H, W, C]
    (x after each step, padding steps included)."""
    dev = sched.device
    x = _start_noise(x_init, n_sample, img_shape, generator, dev)
    c2, mask2 = _cfg_inputs(n_sample, n_classes, dc, classes, dev)
    gw = _guide_arr(guide_w, n_sample, dev)
    if steps is None:
        steps = range(dc.n_T, 0, -1)
    hist = []
    for i in (int(s) for s in steps):
        if i >= 1:
            e = _cfg_eps(eps_fn, x, c2, mask2, i, dc.n_T, gw)
            x_new = sched.oneover_sqrta[i] * (x - e
                                              * sched.mab_over_sqrtmab[i])
            if i > 1:
                z = _step_noise(i, x, noise_fn, slot_seeds, generator)
                x_new = x_new + sched.sqrt_beta_t[i] * z
            x = x_new
        if return_history:
            hist.append(x)
    if return_history:
        return x, torch.stack(hist)
    return x


def ddim_taus(n_T: int, n_steps: int, discretize: str = "uniform"):
    """Ascending tau subsequence over [1, n_T] (the JAX package's rule,
    including the refill of collided "quad" taus)."""
    if n_steps > n_T:
        raise ValueError(f"n_steps={n_steps} exceeds n_T={n_T}")
    if discretize == "quad":
        taus = ((np.linspace(0, np.sqrt(n_T * 0.8), n_steps) ** 2)
                .astype(np.int64) + 1).clip(1, n_T)
        uniq = np.unique(taus)
        if len(uniq) < n_steps:
            unused = np.setdiff1d(np.arange(1, n_T + 1, dtype=np.int64),
                                  uniq)
            uniq = np.sort(np.concatenate(
                [uniq, unused[:n_steps - len(uniq)]]))
        return uniq
    if discretize == "uniform":
        return np.linspace(1, n_T, n_steps).round().astype(np.int64)
    raise ValueError(f"unknown discretize {discretize!r}")


@torch.inference_mode()
def sample_cfg_ddim(eps_fn: EpsFn, generator: Optional[torch.Generator],
                    n_sample: int, img_shape: Tuple[int, int, int],
                    n_classes: int, sched: Schedule, dc: DiffusionConfig,
                    guide_w=0.0, n_steps: int = 50, eta: float = 0.0,
                    classes=None, discretize: str = "uniform", x_init=None,
                    slot_seeds=None, noise_fn: Optional[NoiseFn] = None
                    ) -> torch.Tensor:
    """DDIM over a tau-subsequence of the main family's schedule. With
    ``eta == 0`` the trajectory is deterministic given ``x_init``."""
    dev = sched.device
    x = _start_noise(x_init, n_sample, img_shape, generator, dev)
    c2, mask2 = _cfg_inputs(n_sample, n_classes, dc, classes, dev)
    gw = _guide_arr(guide_w, n_sample, dev)
    taus = [int(t) for t in ddim_taus(dc.n_T, n_steps, discretize)[::-1]]
    taus_prev = taus[1:] + [0]
    ab = torch.cat([torch.ones(1, device=dev), sched.alphabar_t[1:]])
    return _ddim_scan(eps_fn, generator, x, taus, taus_prev, c2, mask2, gw,
                      ab, dc, eta, slot_seeds, noise_fn)


def _ddim_scan(eps_fn, generator, x, taus, taus_prev, c2, mask2, gw, ab, dc,
               eta, slot_seeds=None, noise_fn=None, blend=None):
    """The DDIM update loop (the JAX package's ``lax.scan`` body);
    :func:`sample_cfg_edit` passes ``blend(x, tau_prev)``, applied after
    each update (the inpaint keep-region re-projection)."""
    for tau, tau_p in zip(taus, taus_prev):
        e = _cfg_eps(eps_fn, x, c2, mask2, tau, dc.n_T, gw)
        a, a_prev = ab[tau], ab[tau_p]
        x0 = (x - torch.sqrt(1.0 - a) * e) / torch.sqrt(a)
        sigma = eta * torch.sqrt((1 - a_prev) / (1 - a) * (1 - a / a_prev))
        dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev - sigma ** 2, min=0.0)) * e
        x = torch.sqrt(a_prev) * x0 + dir_xt
        if eta > 0 and tau_p > 0:
            x = x + sigma * _step_noise(tau, x, noise_fn, slot_seeds,
                                        generator)
        if blend is not None:
            x = blend(x, tau_p)
    return x


@torch.inference_mode()
def sample_cfg_edit(eps_fn: EpsFn, generator: Optional[torch.Generator],
                    x0, n_classes: int, sched: Schedule, dc: DiffusionConfig,
                    guide_w=0.0, n_steps: int = 50, strength: float = 0.75,
                    inpaint_mask=None, classes=None, eta: float = 0.0,
                    discretize: str = "uniform", noise=None,
                    noise_fn: Optional[NoiseFn] = None) -> torch.Tensor:
    """img2img / inpaint for the main family over DDIM (the reference's
    LDM recipes, image_to_image.py:95-149 and in_paint.py:100-166, on the
    flagship's discrete schedule).

    ``x0``: [n, h, w, c] source images in [-1, 1]. ``strength``: the share
    of the DDIM trajectory run; x0 is noised to the tau at index
    ``k = max(1, min(n_steps, round(strength * n_steps)))`` from the end
    (1.0: pure generation, x0 entering only through the inpaint blend).
    ``inpaint_mask``: None for img2img, else [h, w], [n, h, w] or
    [n, h, w, c] with 1 = preserve the source pixel; after every update
    the kept region is put back to ``to_tau(tau_prev) = sqrt(abar) x0 +
    sqrt(1 - abar) noise`` with the start point's noise (abar_0 = 1, so
    the last blend leaves the kept pixels equal to x0 exactly).

    ``noise`` (like x0) is that one draw, from ``generator`` on the
    schedule's device unless given; ``noise_fn(tau)`` gives the per-step
    noise when ``eta > 0`` (tests hand in the JAX package's draws through
    both). Same CFG arithmetic and per-sample ``guide_w`` as
    :func:`sample_cfg`."""
    dev = sched.device
    x0 = torch.as_tensor(x0, dtype=torch.float32).to(dev)
    n_sample = x0.shape[0]
    taus_all = ddim_taus(dc.n_T, n_steps, discretize)[::-1]
    k = max(1, min(n_steps, int(round(strength * n_steps))))
    taus = [int(t) for t in taus_all[n_steps - k:]]
    taus_prev = taus[1:] + [0]
    if noise is None:
        noise = torch.randn(x0.shape, generator=generator, device=dev)
    noise = torch.as_tensor(noise, dtype=torch.float32).to(dev)
    ab = torch.cat([torch.ones(1, device=dev), sched.alphabar_t[1:]])

    def to_tau(tau: int) -> torch.Tensor:
        a = ab[tau]
        return torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * noise

    x = to_tau(taus[0])
    c2, mask2 = _cfg_inputs(n_sample, n_classes, dc, classes, dev)
    gw = _guide_arr(guide_w, n_sample, dev)
    blend = None
    if inpaint_mask is not None:
        m = torch.as_tensor(inpaint_mask, dtype=torch.float32).to(dev)
        if m.dim() == 2:
            m = m[None, :, :, None]
        elif m.dim() == 3:
            m = m[..., None]

        def blend(xc, tau_p):
            return to_tau(tau_p) * m + xc * (1.0 - m)

        x = blend(x, taus[0])
    return _ddim_scan(eps_fn, generator, x, taus, taus_prev, c2, mask2, gw,
                      ab, dc, eta, noise_fn=noise_fn, blend=blend)


def dpmpp_terms(a_cur, a_nxt):
    """DPM-Solver++(2M) per-step terms from (alphabar_k, alphabar_{k+1})
    pairs, in float64 on the host, returned as float32 numpy arrays
    (al_cur, si_cur, al_nxt, sigma_ratio, expm1_neg_h, inv2r)."""
    a_cur = np.asarray(a_cur, np.float64)
    a_nxt = np.asarray(a_nxt, np.float64)
    al_c, si_c = np.sqrt(a_cur), np.sqrt(1.0 - a_cur)
    al_n, si_n = np.sqrt(a_nxt), np.sqrt(1.0 - a_nxt)
    with np.errstate(divide="ignore"):
        lam_c = np.log(al_c / si_c)
        lam_n = np.log(al_n / si_n)  # +inf at a final (sigma=0) target
    h = lam_n - lam_c
    inv2r = np.zeros_like(h)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv2r[1:] = h[1:] / (2.0 * h[:-1])
    inv2r[~np.isfinite(inv2r)] = 0.0  # first/final step: lower-order
    return tuple(np.asarray(v, np.float32) for v in (
        al_c, si_c, al_n,
        si_n / np.maximum(si_c, 1e-20),
        (al_c * si_n) / (si_c * al_n) - 1.0,
        inv2r,
    ))


def _dpmpp_coeffs(sched: Schedule, n_T: int, n_steps: int, discretize: str):
    """Descending taus and the per-step fp32 coefficients, from the fp32
    alphabar buffer taken to float64 (as the JAX package does)."""
    taus = np.asarray(ddim_taus(n_T, n_steps, discretize))[::-1]
    ab = np.concatenate([np.ones(1), sched.alphabar_t.cpu().numpy()
                         .astype(np.float64)[1:]])
    a_cur = ab[taus]
    a_nxt = ab[np.concatenate([taus[1:], np.zeros(1, np.int64)])]
    return taus.copy(), dpmpp_terms(a_cur, a_nxt)


@torch.inference_mode()
def sample_cfg_dpmpp(eps_fn: EpsFn, generator: Optional[torch.Generator],
                     n_sample: int, img_shape: Tuple[int, int, int],
                     n_classes: int, sched: Schedule, dc: DiffusionConfig,
                     guide_w=0.0, n_steps: int = 20, classes=None,
                     discretize: str = "uniform", x_init=None
                     ) -> torch.Tensor:
    """DPM-Solver++(2M) in x0-prediction form (Lu et al. 2022):
        x0_k = (x - sigma_k * eps_cfg) / alpha_k
        D    = (1 + 1/(2r)) x0_k - 1/(2r) x0_{k-1}
        x   <- (sigma_{k+1}/sigma_k) x - alpha_{k+1} (exp(-h_k) - 1) D
    First and final steps run first-order. Deterministic given x_init."""
    dev = sched.device
    x = _start_noise(x_init, n_sample, img_shape, generator, dev)
    c2, mask2 = _cfg_inputs(n_sample, n_classes, dc, classes, dev)
    gw = _guide_arr(guide_w, n_sample, dev)
    taus, terms = _dpmpp_coeffs(sched, dc.n_T, n_steps, discretize)
    al_c, si_c, al_n, ratio, em1, inv2r = (
        torch.from_numpy(v).to(dev) for v in terms)
    x0_prev = torch.zeros_like(x)
    for k, tau in enumerate(int(t) for t in taus):
        e = _cfg_eps(eps_fn, x, c2, mask2, tau, dc.n_T, gw)
        x0 = (x - si_c[k] * e) / al_c[k]
        d = (1.0 + inv2r[k]) * x0 - inv2r[k] * x0_prev
        x = ratio[k] * x - al_n[k] * em1[k] * d
        x0_prev = x0
    return x
