"""Seeded weights, made on the device in one draw.

Every parameter of a module, taken in the order of its sorted names, gets
its slice of one ``torch.rand`` draw from a ``torch.Generator`` on the
module's device seeded from ``--seed``, mapped to:

- a weight of two or more dimensions: U(-a, a), a = sqrt(3 / fan_in)
  (unit variance through a layer; fan_in as PyTorch computes it);
- a one-dimensional ``weight`` (a norm's scale): 1 + U(-0.1, 0.1);
- any other parameter (biases, gates): U(-0.1, 0.1).

The program's module and the plain reference carry the same names and
shapes, so each side gets the same numbers from the seed, and the
reference works them out again instead of reading them from the program.
"""

from __future__ import annotations

import math
from typing import Iterator, Tuple

import numpy as np
import torch


def derive(seed: int, *salt: int) -> int:
    """A 63-bit generator seed from ``seed`` (any size) and a salt."""
    return int(np.random.SeedSequence([int(seed) % 2 ** 128, *salt])
               .generate_state(1, np.uint64)[0] >> 1)


def _fan_in(shape) -> int:
    field = math.prod(shape[2:]) if len(shape) > 2 else 1
    return shape[1] * field


@torch.no_grad()
def initial(module: torch.nn.Module, seed: int
            ) -> Iterator[Tuple[str, torch.nn.Parameter, torch.Tensor]]:
    """(name, parameter, its seeded value) over ``module``'s parameters in
    sorted-name order; the values are views of one draw on the module's
    device."""
    params = sorted(module.named_parameters(), key=lambda kv: kv[0])
    dev = params[0][1].device
    total = sum(p.numel() for _, p in params)
    gen = torch.Generator(device=dev).manual_seed(derive(seed, 1))
    u = torch.rand(total, generator=gen, device=dev)
    u.mul_(2.0).sub_(1.0)  # U(-1, 1)
    off = 0
    for name, p in params:
        v = u[off:off + p.numel()].view(p.shape)
        off += p.numel()
        if p.dim() >= 2:
            v.mul_(math.sqrt(3.0 / _fan_in(p.shape)))
        elif name.endswith("weight"):
            v.mul_(0.1).add_(1.0)
        else:
            v.mul_(0.1)
        yield name, p, v


@torch.no_grad()
def fill_(module: torch.nn.Module, seed: int) -> None:
    for _, p, v in initial(module, seed):
        p.copy_(v)
