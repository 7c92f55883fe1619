"""Pooled statistics of H-sharded activations (counterpart of
``diffusionmodel_tpu/parallel/spatial.py``).

Each process holds an H-slab [B, h, W, C] of an NHWC batch (equal slabs,
in rank order along ``axis_name``, as the JAX package's ``image_sharding``
lays an NHWC batch out)
and the global statistics SE and CoordAttn need come from one
``all_reduce`` of the slabs' partial sums:

- :func:`sharded_global_mean`: the mean over (H, W), [B, C] on every
  process;
- :func:`sharded_se_block`: SE with the tiny MLP run replicated and the
  gate applied to the local slab;
- :func:`sharded_directional_pools`: CoordAttn's pools, the H-pool local
  (it stays sharded), the W-pool summed over the slabs.

Plain torch, forward only. The spatially sharded forward that would use
them (halo exchange, ``constrain_spatial``) is ROADMAP A12b.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from diffusionmodel_tpu_torch.parallel.mesh import Mesh


def _sum_over(mesh: Mesh, x: torch.Tensor, axis_name: str) -> torch.Tensor:
    if mesh.distributed:
        dist.all_reduce(x, group=mesh.group(axis_name))
    return x


def sharded_global_mean(mesh: Mesh, x: torch.Tensor,
                        axis_name: str = "data") -> torch.Tensor:
    """x: this process's slab [B, h, W, C] -> the global mean [B, C]."""
    total = _sum_over(mesh, x.sum(dim=(1, 2)), axis_name)
    return total / (x.shape[1] * mesh.shape[axis_name] * x.shape[2])


def sharded_se_block(mesh: Mesh, x: torch.Tensor, w1: torch.Tensor,
                     w2: torch.Tensor, axis_name: str = "data"
                     ) -> torch.Tensor:
    """SE on a slab: ``x * sigmoid(gelu(mean @ w1) @ w2)`` with the mean
    over the whole image (w1 [C, R], w2 [R, C]: the JAX layout)."""
    pooled = sharded_global_mean(mesh, x, axis_name)
    y = torch.sigmoid(F.gelu(pooled @ w1) @ w2)
    return x * y[:, None, None, :]


def sharded_directional_pools(mesh: Mesh, x: torch.Tensor,
                              axis_name: str = "data"
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CoordAttn's pools of a slab: (x_h [B, h, C], this slab's rows of
    the mean over W; x_w [B, W, C], the mean over the whole H)."""
    x_h = x.mean(dim=2)
    x_w = _sum_over(mesh, x.sum(dim=1), axis_name)
    return x_h, x_w / (x.shape[1] * mesh.shape[axis_name])
