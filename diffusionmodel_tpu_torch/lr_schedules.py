"""Learning-rate schedules (counterpart of ``diffusionmodel_tpu/lr_schedules.py``).

- ``cosine_warm_restarts``: torch CosineAnnealingWarmRestarts(T_0=10,
  T_mult=2, eta_min=3e-5) stepped once per epoch (new_scripy.py:722-724,
  848), in its T_mult=2 closed form: epoch e lies in cycle
  i = floor(log2(e/T0 + 1)) of length T_i = T0 * 2^i starting at
  T0*(2^i - 1); lr = eta_min + (lr0 - eta_min) * (1 + cos(pi * t_cur / T_i)) / 2.
- ``linear_decay``: lr0 * (1 - ep/n_epoch) set at each epoch start
  (MNIST_script.py:334).
- ``constant``: lr0 (kind ``"none"``).

Each schedule is a function of the *optimizer step count* (``steps_per_epoch``
reproduces the per-epoch stepping) and returns a Python float holding a
float32 value: the arithmetic runs on float32 CPU tensors, op for op as the
JAX package's does in ``jnp``, so the two give the same float32 rates.
"""

from __future__ import annotations

import math

import torch

_F32 = torch.float32


def _epoch(count: int, steps_per_epoch: int) -> torch.Tensor:
    return torch.tensor(int(count) // steps_per_epoch, dtype=_F32)


def cosine_warm_restarts(lr0: float, steps_per_epoch: int, t0: int = 10,
                         t_mult: int = 2, eta_min: float = 3e-5):
    if t_mult != 2:
        raise ValueError("closed form implemented for T_mult=2 (the "
                         f"reference value), got {t_mult}")

    def schedule(count) -> float:
        e = _epoch(count, steps_per_epoch)
        i = torch.floor(torch.log2(e / t0 + 1.0))
        start = t0 * (2.0 ** i - 1.0)
        t_i = t0 * 2.0 ** i
        t_cur = e - start
        return float(eta_min + (lr0 - eta_min)
                     * (1.0 + torch.cos(math.pi * t_cur / t_i)) / 2.0)

    return schedule


def linear_decay(lr0: float, steps_per_epoch: int, n_epoch: int):
    def schedule(count) -> float:
        e = _epoch(count, steps_per_epoch)
        return float(lr0 * (1.0 - e / n_epoch))

    return schedule


def constant(lr0: float, *_):
    value = float(torch.tensor(lr0, dtype=_F32))

    def schedule(count) -> float:
        return value

    return schedule


def build_schedule(kind: str, lr0: float, steps_per_epoch: int, *, n_epoch: int,
                   t0: int = 10, t_mult: int = 2, eta_min: float = 3e-5):
    if kind == "cosine_warm_restarts":
        return cosine_warm_restarts(lr0, steps_per_epoch, t0, t_mult, eta_min)
    if kind == "linear":
        return linear_decay(lr0, steps_per_epoch, n_epoch)
    if kind == "none":
        return constant(lr0)
    raise ValueError(f"unknown lr schedule {kind!r}")
