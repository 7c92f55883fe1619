"""Plain float32 diffusion arithmetic of the ContextUnet family, written
from the published training script (Shen-Yuuu/DiffusionModel
``new_scripy.py``) and DPM-Solver++(2M) (Lu et al. 2022):

- the linear DDPM schedule, t = 0..T, in float64 rounded once to float32;
- classifier-free guidance as the script computes it: the first half of
  the doubled batch carries no class, and eps = (1+w) eps_0 - w eps_c;
- DPM-Solver++(2M) over the uniform subsequence of [1, T];
- the attention-weighted loss with its feature-consistency term and its
  draws (t, eps, keep-mask), taken from a ``torch.Generator`` in the order
  the training step takes them;
- AdamW after a clip by the global norm (optax's chain: no epsilon in the
  clip, decoupled decay scaled by the rate).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch


def schedule(beta1: float, beta2: float, n_t: int, device) -> Dict:
    t = np.arange(0, n_t + 1, dtype=np.float64)
    beta = (beta2 - beta1) * t / n_t + beta1
    abar = np.exp(np.cumsum(np.log(1.0 - beta)))
    return {"abar": torch.from_numpy(abar.astype(np.float32)).to(device),
            "abar64": abar.astype(np.float32).astype(np.float64)}


def start_noise(seed: int, n: int, img: int, ch: int) -> np.ndarray:
    """A request's start noise: a standard normal from its own seed."""
    return np.random.default_rng(seed).standard_normal(
        (n, img, img, ch), np.float32)


def dpmpp_plan(abar64: np.ndarray, n_t: int, steps: int):
    taus = np.linspace(1, n_t, steps).round().astype(np.int64)[::-1]
    ab = np.concatenate([np.ones(1), abar64[1:]])
    a_c = ab[taus]
    a_n = ab[np.concatenate([taus[1:], np.zeros(1, np.int64)])]
    al_c, si_c = np.sqrt(a_c), np.sqrt(1.0 - a_c)
    al_n, si_n = np.sqrt(a_n), np.sqrt(1.0 - a_n)
    with np.errstate(divide="ignore"):
        h = np.log(al_n / si_n) - np.log(al_c / si_c)
    inv2r = np.zeros_like(h)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv2r[1:] = h[1:] / (2.0 * h[:-1])
    inv2r[~np.isfinite(inv2r)] = 0.0
    terms = (al_c, si_c, al_n, si_n / np.maximum(si_c, 1e-20),
             (al_c * si_n) / (si_c * al_n) - 1.0, inv2r)
    rows = [tuple(np.float32(v) for v in row) for row in zip(*terms)]
    return [int(t) for t in taus], rows


@torch.no_grad()
def sample_dpmpp(net, x: torch.Tensor, classes: torch.Tensor,
                 guide: torch.Tensor, abar64: np.ndarray, n_t: int,
                 steps: int) -> torch.Tensor:
    """DPM-Solver++(2M) with guidance from start noise x [n,H,W,C];
    ``guide`` [n] per sample."""
    n = x.shape[0]
    dev = x.device
    c2 = torch.cat([classes, classes]).long()
    keep = torch.cat([torch.zeros(n), torch.ones(n)]).to(dev)
    w = guide.float().reshape(n, 1, 1, 1)
    taus, rows = dpmpp_plan(abar64, n_t, steps)
    x0_prev = torch.zeros_like(x)
    for tau, (al_c, si_c, al_n, ratio, em1, inv2r) in zip(taus, rows):
        t = torch.full((2 * n,), float(tau), device=dev) / n_t
        e = net(torch.cat([x, x]), c2, t, keep).float()
        eps = (1.0 + w) * e[:n] - w * e[n:]
        x0 = (x - float(si_c) * eps) / float(al_c)
        d = (1.0 + float(inv2r)) * x0 - float(inv2r) * x0_prev
        x = float(ratio) * x - float(al_n) * float(em1) * d
        x0_prev = x0
    return x


def draws(gen: torch.Generator, b: int, shape: Sequence[int], n_t: int,
          drop_prob: float, device) -> Dict:
    """t ~ U[1, T], eps ~ N(0, 1), keep ~ Bernoulli(1 - drop_prob), drawn
    in that order."""
    ts = torch.randint(1, n_t + 1, (b,), generator=gen, device=device)
    noise = torch.randn(tuple(shape), generator=gen, device=device)
    keep = torch.rand(b, generator=gen, device=device) < 1.0 - drop_prob
    return {"ts": ts, "noise": noise, "keep": keep}


def decode_batch(x_u8: torch.Tensor, mask_u8: torch.Tensor, dc: Dict):
    """uint8 images to [-1, 1]; mask class indices {0,1,2} to the low,
    mid and high loss weights."""
    x = (x_u8.float() / 255.0 - 0.5) / 0.5
    vals = torch.tensor([dc["low_weight"], dc["mid_weight"],
                         dc["high_weight"]], device=x.device)
    return x, vals[mask_u8.long()]


def weighted_loss(net, x, c, mask, d: Dict, abar: torch.Tensor,
                  dc: Dict) -> torch.Tensor:
    ts = d["ts"]
    sab = torch.sqrt(abar[ts])[:, None, None, None]
    smab = torch.sqrt(1.0 - abar[ts])[:, None, None, None]
    x_t = sab * x + smab * d["noise"]
    eps = net(x_t, c, ts.float() / dc["n_T"], d["keep"].float(),
              mask).float()
    noise = d["noise"]
    w = torch.where(mask > dc["high_thresh"], dc["high_weight"],
                    torch.where(mask > dc["mid_thresh"], dc["mid_weight"],
                                dc["low_weight"]))[..., None]
    high = (mask > dc["high_thresh"]).float()[..., None]
    return torch.mean((noise - eps) ** 2 * w) + dc["feat_consist_weight"] \
        * torch.mean(torch.abs(eps * high - noise * high))


class AdamW:
    """optax ``chain(clip_by_global_norm(clip), adamw(lr, b1, b2, eps,
    weight_decay))`` over a parameter list, in float32."""

    def __init__(self, params: List[torch.Tensor], lr: float, wd: float,
                 clip: float, b1=0.9, b2=0.999, eps=1e-8):
        self.params, self.lr, self.wd, self.clip = params, lr, wd, clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """One update; returns the clipped gradients it took."""
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
        if self.clip > 0 and float(norm) >= self.clip:
            grads = [g / norm * self.clip for g in grads]
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps) + self.wd * p
            p.add_(u, alpha=-self.lr)
        return grads
