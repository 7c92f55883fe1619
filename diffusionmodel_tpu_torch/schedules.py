"""DDPM noise-schedule precomputation (counterpart of
``diffusionmodel_tpu/schedules.py``).

Reference formulation (``new_scripy.py:358-384``)::

    beta_t    = (beta2-beta1) * arange(0, T+1)/T + beta1      (linear, T+1 pts)
    alphabar  = exp(cumsum(log(1 - beta_t)))                  (index 0..T)

Index 0 carries beta1 and the buffers have length T+1; the sampler walks
i = T..1. The math runs on the host in float64 with ONE final rounding to
float32, exactly as the JAX package does, so the seven buffers are
bit-equal across the two packages.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from diffusionmodel_tpu_torch.device_check import resolve_device

SCHEDULE_KEYS = (
    "alpha_t",
    "oneover_sqrta",
    "sqrt_beta_t",
    "alphabar_t",
    "sqrtab",
    "sqrtmab",
    "mab_over_sqrtmab",
)


def ddpm_schedules_np(beta1: float, beta2: float, T: int) -> Dict[str, np.ndarray]:
    """Host-side schedule computation: float64 math, one rounding to fp32."""
    if not 0.0 < beta1 < beta2 < 1.0:
        raise ValueError("betas must satisfy 0 < beta1 < beta2 < 1")
    t = np.arange(0, T + 1, dtype=np.float64)
    beta_t = (beta2 - beta1) * t / T + beta1
    sqrt_beta_t = np.sqrt(beta_t)
    alpha_t = 1.0 - beta_t
    alphabar_t = np.exp(np.cumsum(np.log(alpha_t), axis=0))
    out64 = {
        "alpha_t": alpha_t,
        "oneover_sqrta": 1.0 / np.sqrt(alpha_t),
        "sqrt_beta_t": sqrt_beta_t,
        "alphabar_t": alphabar_t,
        "sqrtab": np.sqrt(alphabar_t),
        "sqrtmab": np.sqrt(1.0 - alphabar_t),
        "mab_over_sqrtmab": (1.0 - alpha_t) / np.sqrt(1.0 - alphabar_t),
    }
    return {k: v.astype(np.float32) for k, v in out64.items()}


def ddpm_schedules(beta1: float, beta2: float, T: int,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> Dict[str, torch.Tensor]:
    """The 7 DDPM schedule buffers, each [T+1] float32, on ``device``
    (default CUDA; see ``device_check.resolve_device``)."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(v).to(dev)
            for k, v in ddpm_schedules_np(beta1, beta2, T).items()}
