"""Coordinate attention: the hand-written CUDA kernel, its plain twin and
the weight packing.

Counterpart of ``diffusionmodel_tpu/kernels/coord_attn.py``. The kernel
(``csrc/coord_attn.cu``) replaces the Pallas kernel reached from
``coord_attn_fused``; the source notes its design and what bounds it.

:func:`coord_attn` takes the kernel for a CUDA tensor and the plain
PyTorch twin :func:`coord_attn_plain` for a CPU tensor, and raises for
anything the kernel does not take. It never falls back from CUDA to the
twin.

Norm kinds, as in the JAX package: ``"group"`` computes GroupNorm
statistics of the pooled [L, R] tensors per sample; ``"affine"`` is an
inference BatchNorm folded to scale/shift.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, fields

import torch
import torch.nn.functional as F

from diffusionmodel_tpu_torch.kernels import _build, per_sample_matmul

# The pooling pass splits each sample's rows into at most this many tiles,
# one block each (per 64 channels): 384-3072 blocks at the flagship sites
# at batch 16, and column partial sums at most 8x the pooled size.
MAX_ROW_TILES = 8
# The pooling kernel keeps 16 column sums per thread over 16 threads.
MAX_SIDE = 256
# Shared memory a Hopper block can take (the mix kernel holds [2, L, R]).
MAX_SHARED_BYTES = 232448


@dataclass
class CoordAttnWeights:
    """Flat, kernel-ready packing of CoordAttn parameters (float32):

    - ``w1h``, ``w1w`` [C+1, R]: 1x1 conv C->R kernels, bias as last row;
    - ``nh``, ``nw`` [2, R]: norm scale and shift (GroupNorm weight/bias,
      or BatchNorm folded with its running statistics);
    - ``wmix`` [2(R+1), R]: the h2w projection then the w2h projection,
      each with its bias row;
    - ``wout`` [2R, C]: the conv_h then conv_w kernels;
    - ``bout`` [2, C]: their biases;
    - ``scal`` [4] (or the JAX package's [1, 128]): sigmoid(gamma_h),
      sigmoid(gamma_w), alpha-hat, beta-hat.
    """

    w1h: torch.Tensor
    w1w: torch.Tensor
    nh: torch.Tensor
    nw: torch.Tensor
    wmix: torch.Tensor
    wout: torch.Tensor
    bout: torch.Tensor
    scal: torch.Tensor

    @classmethod
    def from_module(cls, mod, norm_kind: str = "group") -> "CoordAttnWeights":
        """Pack the parameters of an ``nn.coord_attn.CoordAttn``."""

        def kern(conv):  # torch [O, I, 1, 1] -> [I, O]
            return conv.weight.reshape(conv.out_channels, conv.in_channels).t()

        def fold(conv):
            return torch.cat([kern(conv), conv.bias[None, :]], dim=0)

        if norm_kind == "affine":
            def norm(bn):
                inv = bn.weight / torch.sqrt(bn.running_var + bn.eps)
                return torch.stack([inv, bn.bias - bn.running_mean * inv])
        elif norm_kind == "group":
            def norm(gn):
                return torch.stack([gn.weight, gn.bias])
        else:
            raise ValueError(f"unknown norm_kind {norm_kind!r}")

        gh, gw, al, be = (torch.sigmoid(p.reshape(())) for p in (
            mod.gamma_h, mod.gamma_w, mod.alpha, mod.beta))
        ssum = al + be + 1e-8
        return cls(
            w1h=fold(mod.conv1_h), w1w=fold(mod.conv1_w),
            nh=norm(mod.bn1_h), nw=norm(mod.bn1_w),
            wmix=torch.cat([fold(mod.h2w_proj), fold(mod.w2h_proj)], dim=0),
            wout=torch.cat([kern(mod.conv_h), kern(mod.conv_w)], dim=0),
            bout=torch.stack([mod.conv_h.bias, mod.conv_w.bias]),
            scal=torch.stack([gh, gw, al / ssum, be / ssum]),
        )


def _group_norm(v: torch.Tensor, groups: int, scale: torch.Tensor,
                bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """GN over [B, L, R]: statistics per sample and group over (L, R/g)."""
    b, l, r = v.shape
    vg = v.reshape(b, l, groups, r // groups)
    mean = vg.mean(dim=(1, 3), keepdim=True)
    var = ((vg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    vn = ((vg - mean) * torch.rsqrt(var + eps)).reshape(b, l, r)
    return vn * scale + bias


def coord_attn_plain(x: torch.Tensor, wts: CoordAttnWeights,
                     norm_kind: str = "group", gn_groups: int = 4
                     ) -> torch.Tensor:
    """Plain twin of the kernel (the counterpart of ``coord_attn_xla``).
    x: [B,H,W,C] with H == W."""
    xf = x.float()
    xh = xf.mean(dim=2)  # [B, H, C]
    xw = xf.mean(dim=1)  # [B, W, C]
    r = wts.w1h.shape[-1]
    mm = per_sample_matmul
    xh1 = mm(xh, wts.w1h[:-1]) + wts.w1h[-1]
    xw1 = mm(xw, wts.w1w[:-1]) + wts.w1w[-1]
    if norm_kind == "affine":
        xh1 = xh1 * wts.nh[0] + wts.nh[1]
        xw1 = xw1 * wts.nw[0] + wts.nw[1]
    elif norm_kind == "group":
        xh1 = _group_norm(xh1, gn_groups, wts.nh[0], wts.nh[1])
        xw1 = _group_norm(xw1, gn_groups, wts.nw[0], wts.nw[1])
    else:
        raise ValueError(f"unknown norm_kind {norm_kind!r}")
    xh1 = F.gelu(xh1)
    xw1 = F.gelu(xw1)
    h2w = mm(xh1, wts.wmix[:r]) + wts.wmix[r]
    w2h = mm(xw1, wts.wmix[r + 1:2 * r + 1]) + wts.wmix[2 * r + 1]
    s = wts.scal.reshape(-1)
    xh2 = xh1 + s[0] * w2h
    xw2 = xw1 + s[1] * h2w
    a_h = torch.sigmoid(mm(xh2, wts.wout[:r]) + wts.bout[0])
    a_w = torch.sigmoid(mm(xw2, wts.wout[r:]) + wts.bout[1])
    attn = s[2] * a_h[:, :, None, :] + s[3] * a_w[:, None, :, :]
    return (xf * attn).to(x.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("coord_attn")
    if lib.coord_attn_forward.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.coord_attn_forward.argtypes = [p] * 15 + [i] * 8 + [p]
        lib.coord_attn_forward.restype = ctypes.c_int
        lib.ca_in_slice.argtypes = []
        lib.ca_in_slice.restype = ctypes.c_int
    return lib


def coord_attn(x: torch.Tensor, wts: CoordAttnWeights,
               norm_kind: str = "group", gn_groups: int = 4) -> torch.Tensor:
    """x: [B,L,L,C] contiguous NHWC (square maps).

    CPU tensors take :func:`coord_attn_plain`; CUDA tensors launch the
    kernel (``coord_attn.launches`` counts those calls)."""
    if x.device.type == "cpu":
        return coord_attn_plain(x, wts, norm_kind, gn_groups)
    if x.device.type != "cuda":
        raise ValueError(f"coord_attn: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(
            f"coord_attn: x must be [B,H,W,C], got {tuple(x.shape)}")
    b, h, w, c = x.shape
    r = wts.w1h.shape[-1]
    if x.dtype != torch.float32:
        raise TypeError(
            f"coord_attn: the kernel takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("coord_attn: x must be contiguous NHWC "
                         "(a channels_last NCHW tensor, permuted)")
    if h != w or h > MAX_SIDE:
        raise ValueError(f"coord_attn: the kernel takes square maps with "
                         f"side <= {MAX_SIDE}, got {h}x{w}")
    if x.data_ptr() % 16 or c % 4 or b * h == 0:
        raise ValueError(f"coord_attn: needs a 16-byte aligned x with "
                         f"C % 4 == 0 and no empty axis, got {tuple(x.shape)}")
    if norm_kind == "group":
        kind, groups = 0, gn_groups
        if groups < 1 or r % groups:
            raise ValueError(f"coord_attn: R={r} not divisible into "
                             f"{groups} groups")
    elif norm_kind == "affine":
        kind, groups = 1, 1
    else:
        raise ValueError(f"unknown norm_kind {norm_kind!r}")
    if (2 * h * r + 2 * r + 4 * groups) * 4 > MAX_SHARED_BYTES:
        raise ValueError(f"coord_attn: L={h}, R={r} exceed the mix "
                         "kernel's shared memory")
    shapes = {"w1h": (c + 1, r), "w1w": (c + 1, r), "nh": (2, r),
              "nw": (2, r), "wmix": (2 * (r + 1), r), "wout": (2 * r, c),
              "bout": (2, c)}
    packed = {}
    for f in fields(wts):
        t = getattr(wts, f.name)
        if f.name in shapes and tuple(t.shape) != shapes[f.name]:
            raise ValueError(f"coord_attn: {f.name} must be "
                             f"{shapes[f.name]}, got {tuple(t.shape)}")
        packed[f.name] = t.to(device=x.device,
                              dtype=torch.float32).contiguous()
    if packed["scal"].numel() < 4:
        raise ValueError("coord_attn: scal needs 4 values")
    rows = -(-h // min(MAX_ROW_TILES, h))
    n_tiles = -(-h // rows)
    out = torch.empty_like(x)
    scratch = dict(device=x.device, dtype=torch.float32)
    pooled = torch.empty((b, 2, h, c), **scratch)  # [mean over W, over H]
    pw = torch.empty((b, n_tiles, w, c), **scratch)
    lib = _lib()
    y = torch.empty((b, -(-c // lib.ca_in_slice()), 2, h, r), **scratch)
    z = torch.empty((b, 2, h, r), **scratch)
    gates = torch.empty((b, 2, h, c), **scratch)
    ptrs = [packed[f.name].data_ptr() for f in fields(wts)]
    with torch.cuda.device(x.device):
        err = lib.coord_attn_forward(
            x.data_ptr(), *ptrs, out.data_ptr(), pooled.data_ptr(),
            pw.data_ptr(), y.data_ptr(), z.data_ptr(), gates.data_ptr(),
            b, h, c, r, kind, groups, rows, n_tiles,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "coord_attn")
    coord_attn.launches += 1
    return out


coord_attn.launches = 0
