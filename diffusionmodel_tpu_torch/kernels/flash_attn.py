"""Flash-attention forward: the hand-written CUDA kernel and its plain twin.

Counterpart of ``diffusionmodel_tpu/kernels/flash_attn.py``. The kernel
(``csrc/flash_attn.cu``) replaces the Pallas forward ``_flash_forward``
(``flash_attn.py:128``, body ``_flash_kernel``). It is bound by operations:
4·B·H·N·M·D fp32 flops against q, k, v and o read or written once; the
source notes what its design does about that. The two backward passes
(``_flash_dq_kernel``, ``_flash_dkv_kernel``) are not ported yet: this
module serves inference only.

:func:`flash_attention` takes the plain twin :func:`flash_attention_plain`
for a CPU tensor and the kernel for a CUDA tensor, and raises for anything
the kernel does not take. It never falls back from CUDA to the twin.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from diffusionmodel_tpu_torch.kernels import _build

HEAD_DIMS = (16, 32, 40, 64, 80, 160)  # every d_head the LDM archs send

Result = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          want_lse: bool = False) -> Result:
    """q: [B,N,H,D]; k, v: [B,M,H,D] -> o [B,N,H,D] (and, with
    ``want_lse``, the per-row logsumexp of the scaled scores, [B,H,N]).
    The twin of ``attention_xla``: einsum, softmax, einsum."""
    s = torch.einsum("bihd,bjhd->bhij", q, k) * (q.shape[-1] ** -0.5)
    o = torch.einsum("bhij,bjhd->bihd", torch.softmax(s, dim=-1), v)
    if want_lse:
        return o, torch.logsumexp(s, dim=-1)
    return o


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attn")
    if lib.flash_attn_forward.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attn_forward.argtypes = [p] * 5 + [i] * 5 + [ll] * 8 + [p]
        lib.flash_attn_forward.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, b: int, h: int, d: int,
           length: Optional[int] = None) -> None:
    if t.dim() != 4 or t.shape[0] != b or t.shape[2] != h or t.shape[3] != d \
            or (length is not None and t.shape[1] != length):
        raise ValueError(f"flash_attention: {name} has shape "
                         f"{tuple(t.shape)}; want [B,*,H,D] = [{b},*,{h},{d}]")
    if t.dtype != torch.float32:
        raise TypeError(f"flash_attention: the kernel takes float32, "
                        f"{name} is {t.dtype}")
    if t.device.type != "cuda":
        raise ValueError(f"flash_attention: {name} is on {t.device}")
    if t.stride(3) != 1 or t.stride(2) != d or t.stride(0) % 4 \
            or t.stride(1) % 4 or t.data_ptr() % 16:
        raise ValueError(
            f"flash_attention: {name} needs a contiguous last axis, heads "
            f"packed at stride D, 16-byte alignment and batch and sequence "
            f"strides divisible by 4; got strides {t.stride()}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    want_lse: bool = False) -> Result:
    """q: [B,N,H,D]; k, v: [B,M,H,D], read through their strides (a
    ``to_q`` output viewed as [B,N,H,D] needs no copy). Returns o
    [B,N,H,D] contiguous, and with ``want_lse`` also L [B,H,N] fp32.

    CPU tensors take :func:`flash_attention_plain`; CUDA tensors launch the
    kernel (``flash_attention.launches`` counts those calls)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, want_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dim() != 4:
        raise ValueError(f"flash_attention: q must be [B,N,H,D], got "
                         f"{tuple(q.shape)}")
    b, n, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} is not built; the "
                         f"kernel takes D in {HEAD_DIMS}")
    _check("q", q, b, h, d)
    _check("k", k, b, h, d)
    m = k.shape[1]
    _check("v", v, b, h, d, m)
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k and v must share a device")
    if n == 0 or m == 0 or b * h == 0:
        raise ValueError(f"flash_attention: empty axis in q {tuple(q.shape)}"
                         f" or k {tuple(k.shape)}")
    if b * h > 65535:
        raise ValueError(f"flash_attention: B*H = {b * h} exceeds the grid")
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = (torch.empty((b, h, n), device=q.device, dtype=torch.float32)
           if want_lse else None)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.flash_attn_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if want_lse else None, b, h, n, m, d,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
            v.stride(1), o.stride(0), o.stride(1),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "flash_attention")
    flash_attention.launches += 1
    return (o, lse) if want_lse else o


flash_attention.launches = 0
