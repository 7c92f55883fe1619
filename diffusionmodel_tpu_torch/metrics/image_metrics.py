"""Image-quality metrics: FID / KID / SSIM / PSNR (new_scripy.py:1111-1290),
counterpart of ``diffusionmodel_tpu/metrics/image_metrics.py``.

Reference-parity notes (SURVEY Q6), as in the JAX package:

- SSIM is the reference's *global-statistics* formula over whole images
  (means/stds of the full tensor, C1=0.01^2, C2=0.03^2), not windowed SSIM
  (new_scripy.py:1189-1224).
- PSNR = 20*log10(1/sqrt(MSE)), +inf at MSE=0 (new_scripy.py:1226-1250).
- Both renormalize inputs from [-1,1] to [0,1] when min < 0, and pair the
  i-th real with the i-th generated image.
- FID: Inception-pool features (2048-d), mean/cov, Frechet distance with
  the matrix square root from a float64 ``eigh`` on the host; >= 10
  samples per side (new_scripy.py:1266). KID: unbiased polynomial MMD^2
  over random subsets.

The numpy functions are copies of the JAX module's (bit-equal results).
Features come from an InceptionV3 trunk on ``device`` (cuDNN on the card,
fp32 with TF32 off): with ``inception_weights`` (a torchvision state dict)
the score is reported as ``fid``; without, a trunk with seeded random
weights gives ``fid_proxy``. The proxy's weights are drawn by torch, not
by jax, so proxy scores are comparable within this package and not
against the JAX package's; see ``metrics.inception.proxy_inception``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from diffusionmodel_tpu_torch.device_check import fp32_compute, resolve_device


def _to_unit_range(img: np.ndarray) -> np.ndarray:
    return (img + 1.0) / 2.0 if img.min() < 0 else img


def calc_ssim(img1: np.ndarray, img2: np.ndarray) -> float:
    """Global-statistics SSIM over whole images ([C,H,W] or [H,W,C])."""
    img1 = _to_unit_range(np.asarray(img1, np.float64))
    img2 = _to_unit_range(np.asarray(img2, np.float64))
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu1, mu2 = img1.mean(), img2.mean()
    s1, s2 = img1.std(), img2.std()
    s12 = ((img1 - mu1) * (img2 - mu2)).mean()
    return float(
        ((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
        / ((mu1 ** 2 + mu2 ** 2 + c1) * (s1 ** 2 + s2 ** 2 + c2))
    )


def calc_psnr(img1: np.ndarray, img2: np.ndarray) -> float:
    img1 = _to_unit_range(np.asarray(img1, np.float32))
    img2 = _to_unit_range(np.asarray(img2, np.float32))
    mse = float(np.mean((img1 - img2) ** 2))
    if mse == 0:
        return float("inf")
    return float(20 * np.log10(1.0 / np.sqrt(mse)))


def matrix_sqrt_psd(a: np.ndarray) -> np.ndarray:
    """sqrtm for (near-)PSD matrices by a float64 eigendecomposition on the
    host; negative eigenvalues from rounding are clipped (the reference
    drops the complex part of scipy's sqrtm)."""
    a = np.asarray(a, np.float64)
    w, v = np.linalg.eigh((a + a.T) / 2.0)
    w = np.clip(w, 0.0, None)
    return (v * np.sqrt(w)[None, :]) @ v.T


def frechet_distance(mu1, sigma1, mu2, sigma2) -> float:
    """FID between two Gaussians; the cross term uses trace sqrtm(S1 S2) ==
    trace sqrtm(S1^1/2 S2 S1^1/2), which keeps eigh's input symmetric."""
    mu1 = np.asarray(mu1, np.float64)
    mu2 = np.asarray(mu2, np.float64)
    sigma1 = np.asarray(sigma1, np.float64)
    sigma2 = np.asarray(sigma2, np.float64)
    diff = mu1 - mu2
    s1_half = matrix_sqrt_psd(sigma1)
    covmean = matrix_sqrt_psd(s1_half @ sigma2 @ s1_half)
    fid = diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2.0 * np.trace(
        covmean
    )
    return float(fid)


def polynomial_mmd2(x: np.ndarray, y: np.ndarray, degree: int = 3,
                    gamma: Optional[float] = None,
                    coef0: float = 1.0) -> float:
    """Unbiased MMD^2 with the KID polynomial kernel
    k(a,b) = (gamma a.b + coef0)^degree, gamma = 1/dim (Binkowski et al.,
    ICLR 2018); diagonal terms are left out of the within-set sums."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if gamma is None:
        gamma = 1.0 / x.shape[1]
    kxx = (gamma * (x @ x.T) + coef0) ** degree
    kyy = (gamma * (y @ y.T) + coef0) ** degree
    kxy = (gamma * (x @ y.T) + coef0) ** degree
    m, n = len(x), len(y)
    sum_xx = (kxx.sum() - np.trace(kxx)) / (m * (m - 1))
    sum_yy = (kyy.sum() - np.trace(kyy)) / (n * (n - 1))
    return float(sum_xx + sum_yy - 2.0 * kxy.mean())


def kid_from_feats(real_feats: np.ndarray, gen_feats: np.ndarray,
                   n_subsets: int = 100, subset_size: int = 100,
                   seed: int = 0):
    """Kernel Inception Distance: (mean, std) of the unbiased polynomial
    MMD^2 over random subsets; report mean x 1000 by convention."""
    rng = np.random.RandomState(seed)
    m = min(subset_size, len(real_feats), len(gen_feats))
    vals = []
    for _ in range(n_subsets):
        r = real_feats[rng.choice(len(real_feats), m, replace=False)]
        g = gen_feats[rng.choice(len(gen_feats), m, replace=False)]
        vals.append(polynomial_mmd2(r, g))
    return float(np.mean(vals)), float(np.std(vals))


def _numpy(out) -> np.ndarray:
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    return np.asarray(out)


def resize_to_299(batch: torch.Tensor) -> torch.Tensor:
    """NHWC batch -> [B, 299, 299, C], bilinear with half-pixel centres
    (the reference's ``F.interpolate(..., align_corners=False)``). A side
    larger than 299 is shrunk with antialiasing, as ``jax.image.resize``
    does (without it a 512 px image is off by up to 0.54)."""
    if batch.shape[1] == 299 and batch.shape[2] == 299:
        return batch
    x = batch.permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(299, 299), mode="bilinear",
                      align_corners=False,
                      antialias=max(x.shape[2], x.shape[3]) > 299)
    return x.permute(0, 2, 3, 1)


class ImageMetrics:
    """Batch quality evaluation (FID / SSIM / PSNR), the reference's
    dispatcher semantics (new_scripy.py:1252-1290).

    ``feature_fn`` maps an NHWC float tensor on ``device`` ([B, 299, 299,
    3] in [0, 1]) to ``[B, D]`` features (a tensor or an array); by default
    the InceptionV3 trunk with ``inception_weights``, else the proxy trunk.
    ``device`` defaults to CUDA (no CPU fallback: pass ``device="cpu"``)."""

    def __init__(self, feature_fn: Optional[Callable] = None,
                 inception_weights: Optional[str] = None, batch_size: int = 8,
                 device=None):
        self._feature_fn = feature_fn
        self._inception_weights = inception_weights
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.inception = None  # the trunk, once built
        # "inception" (converted torchvision weights: comparable to
        # published FID), "custom" (a caller's fn) or "proxy" (random
        # weights: reported as fid_proxy so it is never taken for FID)
        self.feature_kind = "custom" if feature_fn is not None else (
            "inception" if inception_weights else "proxy")

    @property
    def fid_key(self) -> str:
        return "fid" if self.feature_kind in ("inception", "custom") \
            else "fid_proxy"

    def _features(self):
        if self._feature_fn is None:
            from diffusionmodel_tpu_torch.metrics.inception import (
                load_inception,
                proxy_inception,
            )

            self.inception = (load_inception(self._inception_weights,
                                             self.device)
                              if self._inception_weights
                              else proxy_inception(device=self.device))
            model = self.inception

            def fn(x):
                with torch.no_grad():
                    return model(x)

            self._feature_fn = fn
        return self._feature_fn

    def extract_features(self, images: np.ndarray) -> np.ndarray:
        """images: [N,H,W,C] in [-1,1] or [0,1]; resized to 299 on the
        device, one channel tiled to three; fp32 with TF32 off, with
        cuDNN's heuristics (autotuning the trunk's shapes costs ~0.8 s and
        saves nothing measurable: NVIDIA H100,
        tools/fp32_autotune_probe.py)."""
        fn = self._features()
        feats = []
        imgs = np.asarray(images, np.float32)
        if imgs.min() < 0:
            imgs = (imgs + 1.0) / 2.0
        with fp32_compute(self.device, autotune=False):
            for i in range(0, len(imgs), self.batch_size):
                batch = torch.from_numpy(imgs[i:i + self.batch_size]).to(
                    self.device)
                if batch.shape[-1] == 1:
                    batch = batch.repeat(1, 1, 1, 3)
                feats.append(_numpy(fn(resize_to_299(batch))))
        return np.concatenate(feats, axis=0)

    def calc_fid(self, real_images: np.ndarray,
                 gen_images: np.ndarray) -> float:
        rf = self.extract_features(real_images).astype(np.float64)
        gf = self.extract_features(gen_images).astype(np.float64)
        mu_r, mu_g = rf.mean(0), gf.mean(0)
        sig_r = np.cov(rf, rowvar=False)
        sig_g = np.cov(gf, rowvar=False)
        return frechet_distance(mu_r, sig_r, mu_g, sig_g)

    calc_ssim = staticmethod(calc_ssim)
    calc_psnr = staticmethod(calc_psnr)

    def evaluate_batch(self, real_images: np.ndarray,
                       gen_images: np.ndarray) -> Dict[str, float]:
        metrics: Dict[str, float] = {}
        real_images = np.asarray(real_images)
        gen_images = np.asarray(gen_images)
        if len(real_images) >= 10 and len(gen_images) >= 10:
            try:
                metrics[self.fid_key] = self.calc_fid(real_images, gen_images)
            except Exception as e:  # mirror the reference's NaN-on-failure
                print(f"FID calculation failed: {e}")
                metrics[self.fid_key] = float("nan")
        if len(real_images) == len(gen_images):
            ssims = [calc_ssim(r, g) for r, g in zip(real_images, gen_images)]
            psnrs = [calc_psnr(r, g) for r, g in zip(real_images, gen_images)]
            if ssims:
                metrics["ssim"] = float(np.mean(ssims))
            if psnrs:
                metrics["psnr"] = float(np.mean(psnrs))
        return metrics
