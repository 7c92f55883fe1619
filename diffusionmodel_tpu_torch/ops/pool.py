"""Adaptive average pooling along one axis, torch bin semantics
(counterpart of ``diffusionmodel_tpu/ops/pool.py``).

CoordAttn (new_scripy.py:119-120) realigns its cross-direction projections
from length H to length W with ``F.adaptive_avg_pool2d``; bins run from
``floor(i*In/Out)`` to ``ceil((i+1)*In/Out)``. On the square maps of this
net it is the identity.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=64)
def _adaptive_avg_matrix(in_size: int, out_size: int) -> np.ndarray:
    m = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        start = int(np.floor(i * in_size / out_size))
        end = int(np.ceil((i + 1) * in_size / out_size))
        m[i, start:end] = 1.0 / (end - start)
    return m


def adaptive_avg_pool_axis(x: torch.Tensor, out_size: int, axis: int
                           ) -> torch.Tensor:
    """Adaptive average pool along one axis (torch bin semantics)."""
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    m = torch.from_numpy(_adaptive_avg_matrix(in_size, out_size)).to(
        device=x.device, dtype=x.dtype)
    x = torch.movedim(x, axis, -1)
    x = torch.einsum("oi,...i->...o", m, x)
    return torch.movedim(x, -1, axis)
