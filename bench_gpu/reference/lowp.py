"""Roundings of the reference's products.

- ``fp8``: the control of a bfloat16 configuration (a program computing
  below the precision it states). Each tensor is scaled by its largest
  magnitude onto float8 e4m3's range (per-tensor scaling, as an fp8
  inference path scales), rounded to e4m3, and scaled back; the product
  itself stays float32.
- ``bf16``: the baseline of a bfloat16 configuration's image check: the
  inputs and weights of every product rounded to bfloat16, the product in
  float32. Its distance from the float32 reference is the error a sound
  bf16 computation of the same request makes, the scale the program's
  distance is read against.
- ``tf32``: for a float32 configuration with TF32 off: the reference run
  with TF32 allowed in cuDNN and cuBLAS (``tf32_allowed``).
"""

from __future__ import annotations

import contextlib

import torch

_E4M3_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 under per-tensor scaling; the gradient passes
    straight through (a training control rounds its forward only)."""
    xd = x.detach()
    scale = xd.abs().amax().float().clamp(min=1e-12) / _E4M3_MAX
    q = ((xd.float() / scale).to(torch.float8_e4m3fn).float() * scale
         ).to(x.dtype)
    return x + (q - xd) if x.requires_grad else q


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


QUANTS = {"fp8": fp8, "bf16": bf16}


@contextlib.contextmanager
def tf32_allowed(on: bool):
    """TF32 in cuDNN and cuBLAS set to ``on`` inside the block."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    before = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = on
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = before
