"""ContextUnet building blocks (counterpart of ``diffusionmodel_tpu/nn/blocks.py``).

Modules take and return NCHW tensors held in ``torch.channels_last``
memory, so that a block's tensor permuted to NHWC is contiguous — the
layout the kernels read. Attribute names follow the reference's
``state_dict`` (new_scripy.py:143-268): ``conv1.0``, ``se.fc.0``,
``channel_compress.0``, ``down.3.conv2.1``, ``model.0.1`` and so on, which
are the keys ``diffusionmodel_tpu/compat/torch_convert.py`` reads.

Mode follows PyTorch's ``module.training``, the JAX package's ``train``
argument: SEBlock takes the CUDA kernel only with ``use_pallas`` and in
eval mode, and BatchNorm uses its running statistics in eval mode.

Compute type follows flax's policy, not ``torch.autocast``: every block
takes ``dtype`` (float32 or bfloat16), parameters stay float32, and each
layer casts its input and parameters to ``dtype`` where it uses them
(flax's ``promote_dtype``), so gradients reach the float32 parameters as
float32. The layers round where the JAX package's bf16 program rounds
(its jaxpr at the tiny size): a convolution or dense layer rounds its
product, then adds the bias in ``dtype`` and rounds again; a norm takes
its statistics and output in float32 and rounds once; the residual's
``/1.414`` divides by 1.414 rounded to ``dtype``. Operations that mix a
bf16 activation with a float32 value promote to float32, as in JAX: the
align-corners upsample (float32 interpolation matrices) and CoordAttn's
plain path (float32 scalars) return float32, which the next layer rounds.
At float32 every layer is the PyTorch layer it extends.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffusionmodel_tpu_torch.kernels import (
    per_sample_conv,
    per_sample_matmul,
)
from diffusionmodel_tpu_torch.kernels.se_block import se_block
from diffusionmodel_tpu_torch.ops.fused_upconv import (
    up2_conv3x3_align_corners_nchw,
)
from diffusionmodel_tpu_torch.ops.resize import (
    upsample_bilinear_align_corners_taps,
    upsample_bilinear_align_corners_nchw,
)

_F32 = torch.float32


def compute_dtype(name: str) -> torch.dtype:
    """``model.dtype`` as the JAX factory maps it: ``"bfloat16"`` is
    bfloat16, anything else float32."""
    return torch.bfloat16 if name == "bfloat16" else _F32


def div_scalar(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x / s`` with ``s`` rounded to x's dtype first, as JAX rounds a
    weakly typed Python scalar (PyTorch would divide a bf16 tensor by the
    float32 ``s`` and round once)."""
    if x.dtype == _F32:
        return x / s
    return x / torch.tensor(s, dtype=x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, torch ``nn.GELU()``'s default. Below float32 it
    follows ``jax.nn.gelu(approximate=False)`` op for op, rounding where
    the JAX program rounds: ``0.5*x * erfc(-x * sqrt(1/2))`` with
    sqrt(1/2) in x's dtype and each product and the erfc rounded to it."""
    if x.dtype == _F32:
        return F.gelu(x)
    return (x * 0.5) * torch.erfc(x * torch.tensor(-0.5 ** 0.5, dtype=x.dtype))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Logistic sigmoid. Below float32 it is ``1 / (1 + exp(-x))`` with
    each step rounded to x's dtype, as XLA expands ``jax.nn.sigmoid``."""
    if x.dtype == _F32:
        return torch.sigmoid(x)
    one = torch.tensor(1.0, dtype=x.dtype)
    return one / (one + torch.exp(-x))


class GELU(nn.Module):
    """``nn.GELU()`` through :func:`gelu` (no parameters, so the
    ``state_dict`` is the same)."""

    def forward(self, x):
        return gelu(x)


def gn_groups(channels: int, preferred: int = 8) -> int:
    """Largest divisor of ``channels`` that is <= preferred."""
    g = max(1, min(preferred, channels))
    while channels % g != 0:
        g -= 1
    return g


def channels_last(x: torch.Tensor) -> torch.Tensor:
    """``x`` in channels_last memory; no copy when it already is."""
    return x.contiguous(memory_format=torch.channels_last)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW tensor -> contiguous NHWC view of the same channels_last memory."""
    return channels_last(x).permute(0, 2, 3, 1)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype`` (flax's ``nn.Conv``
    with ``dtype``): input and weight cast at use, the product rounded,
    then the bias added in ``compute_dtype``. Without gradients a bf16
    convolution runs one sample at a time (``kernels.per_sample_conv``:
    cuDNN would otherwise let a sample's result depend on its batch
    position)."""

    def __init__(self, *args, compute_dtype: torch.dtype = _F32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        if dt == _F32:
            return super().forward(x)
        w = self.weight.to(dt)
        y = per_sample_conv(lambda a: self._conv_forward(a, w, None),
                            x.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)[:, None, None]


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` computing in ``compute_dtype``, as
    :class:`Conv2d`."""

    def __init__(self, *args, compute_dtype: torch.dtype = _F32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        if dt == _F32:
            return super().forward(x)
        y = F.conv_transpose2d(x.to(dt), self.weight.to(dt), None,
                               self.stride, self.padding,
                               self.output_padding, self.groups,
                               self.dilation)
        return y if self.bias is None else y + self.bias.to(dt)[:, None, None]


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` (flax's ``nn.Dense``
    with ``dtype``): the product rounded, then the bias added."""

    def __init__(self, *args, compute_dtype: torch.dtype = _F32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        if dt == _F32:
            return super().forward(x)
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


class GroupNorm(nn.GroupNorm):
    """GroupNorm whose output stays channels_last. ``eps`` is PyTorch's
    1e-5 by default (the ContextUnet reference); flax's GroupNorm, which
    the latent-diffusion modules mirror, uses 1e-6. With a bf16
    ``compute_dtype`` the statistics and the affine run in float32 and the
    output is rounded once, as flax's GroupNorm at ``dtype=bfloat16``.

    On a CPU tensor each sample is normalised on its own: the CPU kernel
    splits its work across samples by thread count (3 intra-op threads do),
    which would let batch neighbours move a sample's result. CUDA tensors
    take one call for the batch."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 compute_dtype: torch.dtype = _F32):
        super().__init__(num_groups, num_channels, eps=eps)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        if dt != _F32:
            x = x.float()
        if x.device.type == "cpu" and x.shape[0] > 1:
            y = torch.cat([channels_last(super(GroupNorm, self).forward(s))
                           for s in x.split(1)])
        else:
            y = channels_last(super().forward(x))
        return y if dt == _F32 else y.to(dt)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm (eps 1e-5, torch momentum 0.1 = flax 0.9) whose output
    stays channels_last.

    In train mode the running statistics follow flax's ``nn.BatchNorm``,
    not PyTorch's: ``running_var`` moves toward the *biased* batch variance
    (the one the batch is normalised with), where ``nn.BatchNorm2d`` would
    take the unbiased one, n/(n-1) larger. A forward run again inside a
    backward pass (``torch.utils.checkpoint``'s recompute) leaves them
    alone, so a rematerialised step updates them once, as ``jax.checkpoint``
    does. Eval mode is PyTorch's. With a bf16 ``compute_dtype`` it
    normalises in float32 and rounds the output, as flax does."""

    def __init__(self, num_features: int, compute_dtype: torch.dtype = _F32):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        if dt != _F32:
            return self._forward_f32(x.float()).to(dt)
        return self._forward_f32(x)

    def _forward_f32(self, x):
        if not self.training:
            return channels_last(super().forward(x))
        out = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                           self.eps)
        if torch._C._current_graph_task_id() == -1:  # not in a backward
            with torch.no_grad():
                xf = x.detach().float()
                mean = xf.mean(dim=(0, 2, 3))
                var = xf.var(dim=(0, 2, 3), unbiased=False)
                self.running_mean.mul_(1.0 - self.momentum).add_(
                    mean, alpha=self.momentum)
                self.running_var.mul_(1.0 - self.momentum).add_(
                    var, alpha=self.momentum)
                self.num_batches_tracked.add_(1)
        return channels_last(out)


def norm_layer(kind: str, channels: int, groups: int = 8,
               dtype: torch.dtype = _F32) -> nn.Module:
    """The JAX package's ``Norm``: GroupNorm(gn_groups(C, groups)) by
    default, BatchNorm for reference parity (SURVEY Q2)."""
    if kind == "group":
        return GroupNorm(gn_groups(channels, groups), channels,
                         compute_dtype=dtype)
    if kind == "batch":
        return BatchNorm2d(channels, compute_dtype=dtype)
    raise ValueError(f"unknown norm kind {kind!r}")


def conv(in_features: int, features: int, kernel: int, stride: int = 1,
         bias: bool = True, dtype: torch.dtype = _F32) -> Conv2d:
    """Conv2d with the JAX package's explicit padding rule."""
    pad = (kernel - 1) // 2 if kernel % 2 == 1 else max(kernel // 2 - 1, 0)
    return Conv2d(in_features, features, kernel, stride=stride,
                  padding=pad, bias=bias, compute_dtype=dtype)


class EmbedFC(nn.Module):
    """Linear -> GELU -> Linear over a flattened input (new_scripy.py:255-268)."""

    def __init__(self, input_dim: int, emb_dim: int,
                 dtype: torch.dtype = _F32):
        super().__init__()
        self.input_dim = input_dim
        self.model = nn.Sequential(
            Linear(input_dim, emb_dim, compute_dtype=dtype), GELU(),
            Linear(emb_dim, emb_dim, compute_dtype=dtype))

    def forward(self, x):
        return self.model(x.reshape(-1, self.input_dim))


def se_module_plain(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                    dtype: torch.dtype = _F32) -> torch.Tensor:
    """The SE block's own path (the JAX module's XLA lines, not the
    kernel's function): the mean taken in float32 and rounded to
    ``dtype``, both products and the gate in ``dtype`` with the weights
    cast, then ``x * gate``. x: [B,H,W,C]; w1: [C,R]; w2: [R,C]. One
    product per sample. At float32 it computes what the kernel's twin
    ``kernels.se_block.se_block_plain`` computes."""
    y = x.float().mean(dim=(1, 2)).to(dtype)
    y = gelu(per_sample_matmul(y, w1.to(dtype)))
    y = sigmoid(per_sample_matmul(y, w2.to(dtype)))
    return x * y[:, None, None, :]


class SEBlock(nn.Module):
    """Squeeze-excitation (new_scripy.py:143-158): global mean ->
    Linear(C->C/r, no bias) -> GELU -> Linear(->C, no bias) -> sigmoid scale.

    With ``use_pallas`` in eval mode the block runs through
    :func:`kernels.se_block.se_block` (the CUDA kernel for CUDA tensors,
    its twin for CPU ones: float32 pooling and MLP, the gate rounded to
    x's dtype); otherwise through :func:`se_module_plain` in ``dtype``.
    The two coincide at float32 and differ in bf16, as in the JAX package.
    ``fc`` keeps the reference's layers for their ``state_dict`` names;
    both paths compute with their weights, one product per sample. The
    kernel reads ``fc[0].weight`` and ``fc[2].weight`` in place (it takes
    ``w1``/``w2`` as their transposed views), so an eval call launches the
    one kernel and no copy."""

    def __init__(self, channels: int, reduction: int = 16,
                 use_pallas: bool = False, dtype: torch.dtype = _F32):
        super().__init__()
        red = max(1, channels // reduction)
        self.use_pallas = use_pallas
        self.dtype = dtype
        self.fc = nn.Sequential(nn.Linear(channels, red, bias=False),
                                GELU(),
                                nn.Linear(red, channels, bias=False),
                                nn.Sigmoid())

    def forward(self, x):
        w1, w2 = self.fc[0].weight.t(), self.fc[2].weight.t()
        if self.use_pallas and not self.training:
            out = se_block(to_nhwc(x), w1, w2)
        else:
            out = se_module_plain(to_nhwc(x), w1, w2, self.dtype)
        return out.permute(0, 3, 1, 2)


class LocalEnhancer(nn.Module):
    """High-attention region enhancement (new_scripy.py:161-174):
    ``x + conv3x3-GN(8)-GELU-conv3x3(x) * (mask > high_thresh)``.

    Q3: takes the spatial attention mask [B, H, W]; with ``mask`` None
    (sampling) the block is the identity, and the branch is not computed."""

    def __init__(self, channels: int, high_thresh: float = 1.2,
                 act: str = "gelu", dtype: torch.dtype = _F32):
        super().__init__()
        self.high_thresh = high_thresh
        self.conv = nn.Sequential(
            conv(channels, channels, 3, dtype=dtype),
            GroupNorm(gn_groups(channels, 8), channels, compute_dtype=dtype),
            GELU() if act == "gelu" else nn.ReLU(),
            conv(channels, channels, 3, dtype=dtype))

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        if mask is None:
            return x
        gate = (mask > self.high_thresh).to(x.dtype)[:, None, :, :]
        return x + self.conv(x) * gate


class ResConvBlock(nn.Module):
    """2x (conv3x3 + Norm + GELU) with optional SE + residual /1.414
    (new_scripy.py:176-209)."""

    def __init__(self, in_ch: int, out_ch: int, is_res: bool = False,
                 use_se: bool = True, norm: str = "group",
                 attn_reduction: int = 16, use_pallas: bool = False,
                 dtype: torch.dtype = _F32):
        super().__init__()
        self.is_res = is_res
        self.same_channels = in_ch == out_ch
        self.conv1 = nn.Sequential(conv(in_ch, out_ch, 3, dtype=dtype),
                                   norm_layer(norm, out_ch, dtype=dtype),
                                   GELU())
        self.conv2 = nn.Sequential(conv(out_ch, out_ch, 3, dtype=dtype),
                                   norm_layer(norm, out_ch, dtype=dtype),
                                   GELU())
        self.se = (SEBlock(out_ch, attn_reduction, use_pallas, dtype)
                   if is_res and use_se else None)

    def forward(self, x):
        x1 = self.conv1(x)
        x2 = self.conv2(x1)
        if not self.is_res:
            return x2
        if self.se is not None:
            x2 = self.se(x2)
        out = (x + x2) if self.same_channels else (x1 + x2)
        return div_scalar(out, 1.414)


class UnetDown(nn.Module):
    """Down block (new_scripy.py:211-235): 1x1 compress (C/4) -> 1x1 adjust
    -> conv3x3 -> ResConvBlock(res) -> 4x4 stride-2 downsample."""

    def __init__(self, in_ch: int, out_ch: int, compress_ratio: int = 4,
                 use_se: bool = True, norm: str = "group",
                 attn_reduction: int = 16, use_pallas: bool = False,
                 dtype: torch.dtype = _F32):
        super().__init__()
        cc = in_ch // compress_ratio
        self.channel_compress = nn.Sequential(
            conv(in_ch, cc, 1, dtype=dtype),
            norm_layer(norm, cc, dtype=dtype), GELU())
        self.ch_adjust = conv(cc, out_ch, 1, dtype=dtype)
        self.down = nn.Sequential(
            conv(out_ch, out_ch, 3, dtype=dtype),
            norm_layer(norm, out_ch, dtype=dtype), GELU(),
            ResConvBlock(out_ch, out_ch, is_res=True, use_se=use_se,
                         norm=norm, attn_reduction=attn_reduction,
                         use_pallas=use_pallas, dtype=dtype),
            conv(out_ch, out_ch, 4, stride=2, dtype=dtype))

    def forward(self, x):
        return self.down(self.ch_adjust(self.channel_compress(x)))


class UpsampleBilinear2x(nn.Module):
    """``nn.Upsample(scale_factor=2, mode='bilinear', align_corners=True)``.
    In the bf16 net (``dtype``) it runs in float32 with the JAX package's
    arithmetic (``ops.resize.upsample_bilinear_align_corners_taps``): JAX
    contracts the activations with float32 interpolation matrices, which
    promotes them to float32. The float32 net keeps PyTorch's upsample."""

    def __init__(self, dtype: torch.dtype = _F32):
        super().__init__()
        self.dtype = dtype

    def forward(self, x):
        if self.dtype == _F32:
            return upsample_bilinear_align_corners_nchw(x, 2)
        return channels_last(upsample_bilinear_align_corners_taps(x, 2))


class UnetUp(nn.Module):
    """Up block (new_scripy.py:237-253): cat(x, skip) -> bilinear x2
    (align_corners=True) -> conv3x3 -> 2x ResConvBlock.

    ``fused_upsample`` computes the same upsample + conv pair through
    :func:`ops.fused_upconv.up2_conv3x3_align_corners_nchw` (the conv at
    half the rows) in ``dtype``, on the same conv's parameters: the
    ``state_dict`` is the same with and without it."""

    def __init__(self, in_ch: int, out_ch: int, norm: str = "group",
                 dtype: torch.dtype = _F32, fused_upsample: bool = False):
        super().__init__()
        self.dtype = dtype
        self.fused_upsample = fused_upsample
        self.model = nn.Sequential(
            nn.Sequential(UpsampleBilinear2x(dtype),
                          conv(in_ch, out_ch, 3, dtype=dtype)),
            ResConvBlock(out_ch, out_ch, norm=norm, dtype=dtype),
            ResConvBlock(out_ch, out_ch, norm=norm, dtype=dtype))

    def forward(self, x, skip):
        x = torch.cat([x, skip], dim=1)
        if not self.fused_upsample:
            return self.model(x)
        dt, c = self.dtype, self.model[0][1]
        x = up2_conv3x3_align_corners_nchw(
            x.to(dt), c.weight.to(dt), c.bias.to(dt))
        return self.model[2](self.model[1](x))
