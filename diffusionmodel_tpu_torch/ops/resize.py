"""Bilinear x2 upsampling with align_corners=True (counterpart of
``diffusionmodel_tpu/ops/resize.py``).

The reference up-path uses ``nn.Upsample(scale_factor=2, mode='bilinear',
align_corners=True)`` (new_scripy.py:242), which PyTorch implements
directly; the JAX package builds interpolation matrices because
``jax.image.resize`` lacks align-corners sampling.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=64)
def _align_corners_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Interpolation matrix M [out, in]: y = M @ x matches
    F.interpolate(mode='bilinear', align_corners=True) along one axis (a
    copy of the JAX package's, which the fused upsample contracts with)."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == 1:
        m[:, 0] = 1.0
        return m
    if out_size == 1:
        m[0, 0] = 1.0
        return m
    scale = (in_size - 1) / (out_size - 1)
    for i in range(out_size):
        src = i * scale
        lo = int(np.floor(src))
        hi = min(lo + 1, in_size - 1)
        frac = src - lo
        m[i, lo] += 1.0 - frac
        m[i, hi] += frac
    return m


def upsample_bilinear_align_corners(x: torch.Tensor, scale: int = 2
                                    ) -> torch.Tensor:
    """Upsample NHWC ``x`` by integer ``scale`` with align_corners=True."""
    return upsample_bilinear_align_corners_nchw(
        x.permute(0, 3, 1, 2), scale).permute(0, 2, 3, 1)


def upsample_bilinear_align_corners_nchw(x: torch.Tensor, scale: int = 2
                                         ) -> torch.Tensor:
    """The same on an NCHW view (channels_last memory inside the net)."""
    return F.interpolate(x, scale_factor=scale, mode="bilinear",
                         align_corners=True)



@lru_cache(maxsize=64)
def _two_taps(in_size: int, out_size: int):
    """Per output row of ``_align_corners_matrix``: its first nonzero
    column and weight, and its second (weight 0 where there is none)."""
    m = _align_corners_matrix(in_size, out_size).copy()
    rows = np.arange(out_size)
    lo = np.argmax(m != 0, axis=1)
    w_lo = m[rows, lo].copy()
    m[rows, lo] = 0.0
    hi = np.argmax(m != 0, axis=1)
    return lo, hi, w_lo, m[rows, hi].copy()


def upsample_bilinear_align_corners_taps(x: torch.Tensor, scale: int = 2
                                         ) -> torch.Tensor:
    """The same upsample of an NCHW ``x``, in float32, with the JAX
    package's arithmetic: its float32 interpolation matrices applied along
    H, then W, each output the sum of its two rounded products (what XLA's
    dot computes, zero terms adding nothing). A bf16 ``x`` is promoted to
    float32, as JAX promotes it."""
    x = x.float()
    for axis in (2, 3):
        n = x.shape[axis]
        lo, hi, w_lo, w_hi = _two_taps(n, n * scale)
        shape = [1, 1, 1, 1]
        shape[axis] = n * scale
        dev = x.device
        a = x.index_select(axis, torch.from_numpy(lo).to(dev))
        b = x.index_select(axis, torch.from_numpy(hi).to(dev))
        x = (a * torch.from_numpy(w_lo).to(dev).reshape(shape)
             + b * torch.from_numpy(w_hi).to(dev).reshape(shape))
    return x
