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


def upsample_bilinear_align_corners_taps(x: torch.Tensor, scale: int = 2,
                                         rows=None) -> torch.Tensor:
    """The same upsample of an NCHW ``x``, in float32, with the JAX
    package's arithmetic: its float32 interpolation matrices applied along
    H, then W, each output the sum of its two rounded products (what XLA's
    dot computes, zero terms adding nothing). A bf16 ``x`` is promoted to
    float32, as JAX promotes it.

    ``rows=(row0, h, H)``: x is an H-slab (rows row0 .. row0 + h of a map
    of H rows) with one halo row on each side, and the result is the
    slab's rows of the whole map's upsample (rows scale * row0 .. scale *
    (row0 + h)): the taps along H are the whole map's, indexed by global
    row (align-corners taps reach at most one row past the slab)."""
    x = x.float()
    dev = x.device
    for axis in (2, 3):
        n = x.shape[axis]
        if axis == 2 and rows is not None:
            row0, h, full = rows
            out = slice(scale * row0, scale * (row0 + h))
            lo, hi, w_lo, w_hi = (t[out] for t in _two_taps(full,
                                                            full * scale))
            hi = np.where(w_hi == 0, lo, hi)  # a lone tap: its own row
            lo, hi = lo - row0 + 1, hi - row0 + 1  # into the haloed slab
            n_out = scale * h
        else:
            lo, hi, w_lo, w_hi = _two_taps(n, n * scale)
            n_out = n * scale
        shape = [1, 1, 1, 1]
        shape[axis] = n_out
        a = x.index_select(axis, torch.from_numpy(lo).to(dev))
        b = x.index_select(axis, torch.from_numpy(hi).to(dev))
        x = (a * torch.from_numpy(w_lo).to(dev).reshape(shape)
             + b * torch.from_numpy(w_hi).to(dev).reshape(shape))
    return x
