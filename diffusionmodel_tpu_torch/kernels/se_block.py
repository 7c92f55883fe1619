"""Squeeze-excitation: the hand-written CUDA kernel and its plain twin.

Counterpart of ``diffusionmodel_tpu/kernels/se_block.py``. The kernel
(``csrc/se_block.cu``) replaces the Pallas kernel reached from
``se_block_fused``; the source notes its design and what bounds it.

:func:`se_block` takes the kernel for a CUDA tensor and the plain PyTorch
twin :func:`se_block_plain` for a CPU tensor, and raises for anything the
kernel does not take. It never falls back from CUDA to the twin.

x is float32 or bfloat16. In bfloat16 both compute what the Pallas kernel
computes on bf16 x (pooling and MLP in float32, the gate rounded to bf16,
one rounding of the product), not what the SE module's own XLA path
computes (``nn.blocks.se_module_plain``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from diffusionmodel_tpu_torch.kernels import _build, per_sample_matmul

# Pixels summed by one block of the pooling pass. 256 gives the flagship
# sites 1.5k-12k blocks at batch 16, and partial sums 1/256 the size of x.
TILE_PIXELS = 256


def se_block_plain(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor
                   ) -> torch.Tensor:
    """x: [B,H,W,C]; w1: [C,R]; w2: [R,C]. x * sigmoid(GELU(mean @ w1) @ w2).
    The twin of the kernel's function (``se_block_fused``, with exact-erf
    GELU as ``se_block_xla``): the mean and the MLP in float32, the gate
    rounded to x's dtype, then x times the gate in float32 (exact for bf16
    operands) rounded once to x's dtype."""
    xf = x.float()
    pooled = xf.mean(dim=(1, 2))
    y = torch.sigmoid(per_sample_matmul(
        F.gelu(per_sample_matmul(pooled, w1.float())), w2.float()))
    gate = y.to(x.dtype).float()
    return (xf * gate[:, None, None, :]).to(x.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("se_block")
    if lib.se_block_forward.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.se_block_forward, lib.se_block_forward_bf16):
            fn.argtypes = [p] * 7 + [i] * 6 + [p]
            fn.restype = ctypes.c_int
        lib.se_slice.argtypes = []
        lib.se_slice.restype = ctypes.c_int
    return lib


def se_block(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor
             ) -> torch.Tensor:
    """x: [B,H,W,C] contiguous NHWC, float32 or bfloat16; w1: [C,R];
    w2: [R,C] (used in float32).

    CPU tensors take :func:`se_block_plain`; CUDA tensors launch the
    kernel (``se_block.launches`` counts those calls)."""
    if x.device.type == "cpu":
        return se_block_plain(x, w1, w2)
    if x.device.type != "cuda":
        raise ValueError(f"se_block: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"se_block: x must be [B,H,W,C], got {tuple(x.shape)}")
    b, h, w, c = x.shape
    r = w1.shape[1] if w1.dim() == 2 else -1
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(
            f"se_block: the kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("se_block: x must be contiguous NHWC "
                         "(a channels_last NCHW tensor, permuted)")
    vec = 16 // x.element_size()  # channels per 16-byte access
    if x.data_ptr() % 16 or c % vec or b * h * w == 0:
        raise ValueError(f"se_block: needs a 16-byte aligned x with C % {vec}"
                         f" == 0 and no empty axis, got {tuple(x.shape)}")
    if tuple(w1.shape) != (c, r) or tuple(w2.shape) != (r, c):
        raise ValueError(f"se_block: weights must be [C,R] and [R,C] for "
                         f"C={c}, got {tuple(w1.shape)} and {tuple(w2.shape)}")
    if r * 4 > 48 * 1024:
        raise ValueError(f"se_block: R={r} exceeds the excite kernel's "
                         "shared memory")
    w1 = w1.to(device=x.device, dtype=torch.float32).contiguous()
    w2 = w2.to(device=x.device, dtype=torch.float32).contiguous()
    hw = h * w
    n_tiles = -(-hw // TILE_PIXELS)
    out = torch.empty_like(x)
    partial = torch.empty((b, n_tiles, c), device=x.device,
                          dtype=torch.float32)
    gate = torch.empty((b, c), device=x.device, dtype=torch.float32)
    lib = _lib()
    hidden_part = torch.empty((b, -(-c // lib.se_slice()), r),
                              device=x.device, dtype=torch.float32)
    fn = (lib.se_block_forward if x.dtype == torch.float32
          else lib.se_block_forward_bf16)
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), w1.data_ptr(), w2.data_ptr(), out.data_ptr(),
            partial.data_ptr(), hidden_part.data_ptr(), gate.data_ptr(), b,
            hw, c, r, TILE_PIXELS, n_tiles,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "se_block")
    se_block.launches += 1
    return out


se_block.launches = 0
