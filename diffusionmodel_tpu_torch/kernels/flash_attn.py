"""Flash attention: the hand-written CUDA kernels and their plain twins.

Counterpart of ``diffusionmodel_tpu/kernels/flash_attn.py``. Three kernels,
each bound by operations (the sources note what their designs do about
that):

- the forward (``csrc/flash_attn.cu``) replaces the Pallas
  ``_flash_forward`` (``flash_attn.py:128``, body ``_flash_kernel``):
  4·B·H·N·M·D flops, o and optionally the per-row logsumexp L;
- the dQ pass (``csrc/flash_attn_bwd.cu``) replaces ``_flash_dq_kernel``
  (``flash_attn.py:152``, launched at ``:268``): 6·B·H·N·M·D flops, dq and
  Delta = rowsum(do∘o);
- the dK/dV pass (same source) replaces ``_flash_dkv_kernel``
  (``flash_attn.py:182``, launched at ``:285``): 8·B·H·N·M·D flops.

All three run their products on the tensor cores as 3xTF32 (each fp32
operand split into two TF32 halves, three TF32 products per fp32 product),
at about fp32 accuracy; :func:`flash_attention_forward_tf32` and
:func:`flash_attention_backward_tf32` emulate that arithmetic in plain
torch for the tests.

:func:`flash_attention` is differentiable: where a gradient is wanted it
runs :class:`FlashAttentionFunction` (the JAX package's ``custom_vjp``),
whose forward keeps L and whose backward runs the two passes; under
``torch.no_grad`` or without inputs that need a gradient it runs the
forward alone, without L. Every kernel has a plain twin here; a CPU tensor
takes the twin, a CUDA tensor the kernel, and anything the kernel does not
take raises. Nothing falls back from CUDA to a twin.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from diffusionmodel_tpu_torch.kernels import _build

HEAD_DIMS = (16, 32, 40, 64, 80, 160)  # every d_head the LDM archs send

Result = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]
Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


# --- plain twins ---------------------------------------------------------------

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


def _probs(q, k, lse):
    """p = exp(q kᵀ/√D − L), [B,H,N,M], recomputed from L as both passes do."""
    s = torch.einsum("bihd,bjhd->bhij", q, k) * (q.shape[-1] ** -0.5)
    return torch.exp(s - lse[..., None])


def flash_attention_dq_plain(q, k, v, o, lse, do
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dQ pass in plain torch: (dq [B,N,H,D], Delta [B,H,N]) with
    Delta = rowsum(do∘o), ds = p(do vᵀ − Delta), dq = ds k/√D."""
    delta = (do * o).sum(-1).transpose(1, 2)
    ds = _probs(q, k, lse) * (torch.einsum("bihd,bjhd->bhij", do, v)
                              - delta[..., None])
    dq = torch.einsum("bhij,bjhd->bihd", ds, k) * (q.shape[-1] ** -0.5)
    return dq, delta


def flash_attention_dkv_plain(q, k, v, do, lse, delta
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV pass in plain torch: (dk, dv), both [B,M,H,D], with
    dv = pᵀ do and dk = dsᵀ q/√D."""
    p = _probs(q, k, lse)
    ds = p * (torch.einsum("bihd,bjhd->bhij", do, v) - delta[..., None])
    dk = torch.einsum("bhij,bihd->bjhd", ds, q) * (q.shape[-1] ** -0.5)
    return dk, torch.einsum("bhij,bihd->bjhd", p, do)


def flash_attention_backward_plain(q, k, v, o, lse, do) -> Grads:
    """What the two Pallas backward passes compute, in plain torch:
    (dq, dk, dv) from the forward's inputs, o, L and the output gradient."""
    dq, delta = flash_attention_dq_plain(q, k, v, o, lse, do)
    return (dq, *flash_attention_dkv_plain(q, k, v, do, lse, delta))


# --- TF32 emulation (tests and docs; the main path never calls it) -------------

def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (10 explicit mantissa bits), ties away
    from zero, as ``cvt.rna.tf32.f32`` rounds; returned as fp32 with the low
    13 bits zero. Works on the int32 view of the bits."""
    i = x.to(torch.float32).contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 toward zero: the low 13 bits dropped, as a tensor core
    reads an fp32 value given to it as a TF32 operand."""
    i = x.to(torch.float32).contiguous().view(torch.int32)
    return (i & ~0x1FFF).view(torch.float32)


def tf32_split(x: torch.Tensor, lo_round: str = "nearest"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) with hi = tf32_round(x) and lo = x - hi as TF32, rounded to
    nearest (``"nearest"``: hi + lo is x to 2^-22 relative) or toward zero
    (``"zero"``: 2^-21; what the kernels do, passing x - hi unrounded)."""
    hi = tf32_round(x)
    rnd = {"nearest": tf32_round, "zero": tf32_truncate}[lo_round]
    return hi, rnd(x - hi)


def _tf32_einsum(eq: str, a: torch.Tensor, b: torch.Tensor, passes: int,
                 lo_round: str) -> torch.Tensor:
    """einsum on TF32 operands: one product of the rounded operands
    (``passes=1``), or lo·hi + hi·lo + hi·hi (``passes=3``, 3xTF32). A
    product of two TF32 values is exact in fp32, so only the sums round."""
    (ah, al), (bh, bl) = tf32_split(a, lo_round), tf32_split(b, lo_round)
    out = torch.einsum(eq, ah, bh)
    if passes == 3:
        out = torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl) + out
    elif passes != 1:
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    return out


def flash_attention_forward_tf32(q, k, v, passes: int = 3,
                                 lo_round: str = "nearest"
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward with both products formed from TF32 operands, as the
    kernel forms them: s = q kᵀ and p·v rounded once (``passes=1``) or split
    into hi and lo (``passes=3``, 3xTF32; ``lo_round="zero"`` is the
    kernel's own rounding of lo), p split like any operand, the softmax and
    its sums in fp32. Returns (o [B,N,H,D], L [B,H,N]). For tests and docs;
    the main path never calls it."""
    s = _tf32_einsum("bihd,bjhd->bhij", q, k, passes, lo_round) \
        * (q.shape[-1] ** -0.5)
    mx = s.amax(-1, keepdim=True)
    p = torch.exp(s - mx)
    total = p.sum(-1, keepdim=True)
    o = _tf32_einsum("bhij,bjhd->bihd", p, v, passes, lo_round) \
        / total.permute(0, 2, 1, 3)
    return o, (mx + torch.log(total)).squeeze(-1)


def flash_attention_backward_tf32(q, k, v, o, lse, do, passes: int = 3,
                                  lo_round: str = "nearest") -> Grads:
    """The two backward passes with every product formed from TF32
    operands: rounded once (``passes=1``) or split into hi and lo
    (``passes=3``, the kernels' 3xTF32 ``mma.sync``; ``lo_round="zero"``
    is the kernels' own rounding of lo), p and ds split like any operand,
    sums in fp32. For tests and docs: it shows why one TF32 pass is not
    accurate enough and 3xTF32 is. The main path never calls it."""
    scale = q.shape[-1] ** -0.5

    def mm(eq, a, b):
        return _tf32_einsum(eq, a, b, passes, lo_round)

    delta = (do * o).sum(-1).transpose(1, 2)
    p = torch.exp(mm("bihd,bjhd->bhij", q, k) * scale - lse[..., None])
    ds = p * (mm("bihd,bjhd->bhij", do, v) - delta[..., None])
    dq = mm("bhij,bjhd->bihd", ds, k) * scale
    dk = mm("bhij,bihd->bjhd", ds, q) * scale
    return dq, dk, mm("bhij,bihd->bjhd", p, do)


# --- kernel wrappers -----------------------------------------------------------

def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attn")
    if lib.flash_attn_forward.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attn_forward.argtypes = [p] * 5 + [i] * 5 + [ll] * 8 + [p]
        lib.flash_attn_forward.restype = ctypes.c_int
    return lib


def _lib_bwd() -> ctypes.CDLL:
    lib = _build.load("flash_attn_bwd")
    for fn in (lib.flash_attn_backward_dq, lib.flash_attn_backward_dkv):
        if fn.argtypes is None:
            p, i = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [p] * 8 + [i] * 5 + [p, p]
            fn.restype = ctypes.c_int
    return lib


def _layout_ok(t: torch.Tensor, d: int) -> bool:
    return (t.stride(3) == 1 and t.stride(2) == d and t.stride(0) % 4 == 0
            and t.stride(1) % 4 == 0 and t.data_ptr() % 16 == 0)


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
    if not _layout_ok(t, d):
        raise ValueError(
            f"flash_attention: {name} needs a contiguous last axis, heads "
            f"packed at stride D, 16-byte alignment and batch and sequence "
            f"strides divisible by 4; got strides {t.stride()}")


def _check_qkv(q, k, v) -> Tuple[int, int, int, int, int]:
    """Validate q [B,N,H,D], k, v [B,M,H,D] for the kernels; (b, n, m, h, d)."""
    if q.dim() != 4:
        raise ValueError(f"flash_attention: q must be [B,N,H,D], got "
                         f"{tuple(q.shape)}")
    b, n, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} is not built; the "
                         f"kernels take D in {HEAD_DIMS}")
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
    return b, n, m, h, d


def _check_rows(name: str, t: torch.Tensor, b: int, h: int, n: int,
                dev: torch.device) -> None:
    if t.shape != (b, h, n) or t.dtype != torch.float32 \
            or t.device != dev or not t.is_contiguous():
        raise ValueError(f"flash_attention: {name} must be contiguous fp32 "
                         f"[B,H,N] = [{b},{h},{n}] on {dev}; got "
                         f"{tuple(t.shape)} {t.dtype} {t.device}")


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             want_lse: bool) -> Result:
    """The forward alone: the twin for a CPU tensor, the kernel for CUDA."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, want_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, n, m, h, d = _check_qkv(q, k, v)
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


def _fit(t: torch.Tensor, d: int) -> torch.Tensor:
    """A gradient (or a saved output) arrives in whatever layout autograd
    made: copy it to the kernels' layout only when its strides do not
    already fit."""
    return t if _layout_ok(t, d) else t.contiguous()


def _strides(*ts: torch.Tensor):
    flat = [s for t in ts for s in (t.stride(0), t.stride(1))]
    return (ctypes.c_longlong * len(flat))(*flat)


def flash_attention_dq(q, k, v, o, lse, do
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dQ kernel on CUDA tensors: (dq [B,N,H,D] contiguous,
    Delta [B,H,N]). q, k, v, o, do are read through their strides
    (``flash_attention_dq.launches`` counts the launches)."""
    b, n, m, h, d = _check_qkv(q, k, v)
    o, do = _fit(o, d), _fit(do, d)
    _check("o", o, b, h, d, n)
    _check("do", do, b, h, d, n)
    _check_rows("lse", lse, b, h, n, q.device)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    delta = torch.empty_like(lse)
    lib = _lib_bwd()
    strides = _strides(q, k, v, o, do, dq)
    with torch.cuda.device(q.device):
        err = lib.flash_attn_backward_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), delta.data_ptr(),
            b, h, n, m, d, ctypes.addressof(strides),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "flash_attention_dq")
    flash_attention_dq.launches += 1
    return dq, delta


def flash_attention_dkv(q, k, v, do, lse, delta
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dK/dV kernel on CUDA tensors: (dk, dv), contiguous
    [B,M,H,D]; ``delta`` is the dQ pass's [B,H,N]
    (``flash_attention_dkv.launches`` counts the launches)."""
    b, n, m, h, d = _check_qkv(q, k, v)
    do = _fit(do, d)
    _check("do", do, b, h, d, n)
    _check_rows("lse", lse, b, h, n, q.device)
    _check_rows("delta", delta, b, h, n, q.device)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    lib = _lib_bwd()
    strides = _strides(q, k, v, do, dk, dv)
    with torch.cuda.device(q.device):
        err = lib.flash_attn_backward_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, n, m, d, ctypes.addressof(strides),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "flash_attention_dkv")
    flash_attention_dkv.launches += 1
    return dk, dv


def flash_attention_backward(q, k, v, o, lse, do) -> Grads:
    """(dq, dk, dv): the plain twin for CPU tensors, the dQ kernel then the
    dK/dV kernel for CUDA tensors."""
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, o, lse, do)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    dq, delta = flash_attention_dq(q, k, v, o, lse, do)
    return (dq, *flash_attention_dkv(q, k, v, do, lse, delta))


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with its streaming backward (the JAX package's
    ``_flash_core`` ``custom_vjp``): the forward keeps (q, k, v, o, L), the
    backward recomputes p from L in the two passes. Returns (o, L); L
    carries no gradient."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = _forward(q, k, v, True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        return flash_attention_backward(*ctx.saved_tensors, do)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    want_lse: bool = False) -> Result:
    """q: [B,N,H,D]; k, v: [B,M,H,D], read through their strides (a
    ``to_q`` output viewed as [B,N,H,D] needs no copy). Returns o
    [B,N,H,D] contiguous, and with ``want_lse`` also L [B,H,N] fp32.

    Differentiable in q, k and v. CPU tensors take the plain twins; CUDA
    tensors launch the kernels (``flash_attention.launches`` counts forward
    launches; ``flash_attention_dq`` and ``flash_attention_dkv`` count the
    backward's)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        o, lse = FlashAttentionFunction.apply(q, k, v)
        return (o, lse) if want_lse else o
    return _forward(q, k, v, want_lse)


flash_attention.launches = 0
flash_attention_dq.launches = 0
flash_attention_dkv.launches = 0
