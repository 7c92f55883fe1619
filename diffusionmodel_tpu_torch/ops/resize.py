"""Bilinear x2 upsampling with align_corners=True (counterpart of
``diffusionmodel_tpu/ops/resize.py``).

The reference up-path uses ``nn.Upsample(scale_factor=2, mode='bilinear',
align_corners=True)`` (new_scripy.py:242), which PyTorch implements
directly; the JAX package builds interpolation matrices because
``jax.image.resize`` lacks align-corners sampling.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
