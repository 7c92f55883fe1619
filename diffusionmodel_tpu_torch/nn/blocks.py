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
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffusionmodel_tpu_torch.kernels.se_block import se_block, se_block_plain
from diffusionmodel_tpu_torch.ops.resize import (
    upsample_bilinear_align_corners_nchw,
)


def gelu(x: torch.Tensor) -> torch.Tensor:
    # torch nn.GELU() default is the exact erf formulation.
    return F.gelu(x)


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


class GroupNorm(nn.GroupNorm):
    """GroupNorm whose output stays channels_last. ``eps`` is PyTorch's
    1e-5 by default (the ContextUnet reference); flax's GroupNorm, which
    the latent-diffusion modules mirror, uses 1e-6.

    On a CPU tensor each sample is normalised on its own: the CPU kernel
    splits its work across samples by thread count (3 intra-op threads do),
    which would let batch neighbours move a sample's result. CUDA tensors
    take one call for the batch."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5):
        super().__init__(num_groups, num_channels, eps=eps)

    def forward(self, x):
        if x.device.type == "cpu" and x.shape[0] > 1:
            return torch.cat([channels_last(super(GroupNorm, self).forward(s))
                              for s in x.split(1)])
        return channels_last(super().forward(x))


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm (eps 1e-5, torch momentum 0.1 = flax 0.9) whose output
    stays channels_last.

    In train mode the running statistics follow flax's ``nn.BatchNorm``,
    not PyTorch's: ``running_var`` moves toward the *biased* batch variance
    (the one the batch is normalised with), where ``nn.BatchNorm2d`` would
    take the unbiased one, n/(n-1) larger. A forward run again inside a
    backward pass (``torch.utils.checkpoint``'s recompute) leaves them
    alone, so a rematerialised step updates them once, as ``jax.checkpoint``
    does. Eval mode is PyTorch's."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x):
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


def norm_layer(kind: str, channels: int, groups: int = 8) -> nn.Module:
    """The JAX package's ``Norm``: GroupNorm(gn_groups(C, groups)) by
    default, BatchNorm for reference parity (SURVEY Q2)."""
    if kind == "group":
        return GroupNorm(gn_groups(channels, groups), channels)
    if kind == "batch":
        return BatchNorm2d(channels)
    raise ValueError(f"unknown norm kind {kind!r}")


def conv(in_features: int, features: int, kernel: int, stride: int = 1,
         bias: bool = True) -> nn.Conv2d:
    """Conv2d with the JAX package's explicit padding rule."""
    pad = (kernel - 1) // 2 if kernel % 2 == 1 else max(kernel // 2 - 1, 0)
    return nn.Conv2d(in_features, features, kernel, stride=stride,
                     padding=pad, bias=bias)


class EmbedFC(nn.Module):
    """Linear -> GELU -> Linear over a flattened input (new_scripy.py:255-268)."""

    def __init__(self, input_dim: int, emb_dim: int):
        super().__init__()
        self.input_dim = input_dim
        self.model = nn.Sequential(nn.Linear(input_dim, emb_dim), nn.GELU(),
                                   nn.Linear(emb_dim, emb_dim))

    def forward(self, x):
        return self.model(x.reshape(-1, self.input_dim))


class SEBlock(nn.Module):
    """Squeeze-excitation (new_scripy.py:143-158): global mean ->
    Linear(C->C/r, no bias) -> GELU -> Linear(->C, no bias) -> sigmoid scale.

    With ``use_pallas`` in eval mode the block runs through
    :func:`kernels.se_block.se_block` (the CUDA kernel for CUDA tensors);
    otherwise through its plain twin. ``fc`` keeps the reference's layers
    for their ``state_dict`` names; the twin computes with their weights,
    one product per sample."""

    def __init__(self, channels: int, reduction: int = 16,
                 use_pallas: bool = False):
        super().__init__()
        red = max(1, channels // reduction)
        self.use_pallas = use_pallas
        self.fc = nn.Sequential(nn.Linear(channels, red, bias=False),
                                nn.GELU(),
                                nn.Linear(red, channels, bias=False),
                                nn.Sigmoid())

    def forward(self, x):
        fn = se_block if self.use_pallas and not self.training \
            else se_block_plain
        out = fn(to_nhwc(x), self.fc[0].weight.t(), self.fc[2].weight.t())
        return out.permute(0, 3, 1, 2)


class LocalEnhancer(nn.Module):
    """High-attention region enhancement (new_scripy.py:161-174):
    ``x + conv3x3-GN(8)-GELU-conv3x3(x) * (mask > high_thresh)``.

    Q3: takes the spatial attention mask [B, H, W]; with ``mask`` None
    (sampling) the block is the identity, and the branch is not computed."""

    def __init__(self, channels: int, high_thresh: float = 1.2,
                 act: str = "gelu"):
        super().__init__()
        self.high_thresh = high_thresh
        self.conv = nn.Sequential(
            conv(channels, channels, 3),
            GroupNorm(gn_groups(channels, 8), channels),
            nn.GELU() if act == "gelu" else nn.ReLU(),
            conv(channels, channels, 3))

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
                 attn_reduction: int = 16, use_pallas: bool = False):
        super().__init__()
        self.is_res = is_res
        self.same_channels = in_ch == out_ch
        self.conv1 = nn.Sequential(conv(in_ch, out_ch, 3),
                                   norm_layer(norm, out_ch), nn.GELU())
        self.conv2 = nn.Sequential(conv(out_ch, out_ch, 3),
                                   norm_layer(norm, out_ch), nn.GELU())
        self.se = (SEBlock(out_ch, attn_reduction, use_pallas)
                   if is_res and use_se else None)

    def forward(self, x):
        x1 = self.conv1(x)
        x2 = self.conv2(x1)
        if not self.is_res:
            return x2
        if self.se is not None:
            x2 = self.se(x2)
        out = (x + x2) if self.same_channels else (x1 + x2)
        return out / 1.414


class UnetDown(nn.Module):
    """Down block (new_scripy.py:211-235): 1x1 compress (C/4) -> 1x1 adjust
    -> conv3x3 -> ResConvBlock(res) -> 4x4 stride-2 downsample."""

    def __init__(self, in_ch: int, out_ch: int, compress_ratio: int = 4,
                 use_se: bool = True, norm: str = "group",
                 attn_reduction: int = 16, use_pallas: bool = False):
        super().__init__()
        cc = in_ch // compress_ratio
        self.channel_compress = nn.Sequential(
            conv(in_ch, cc, 1), norm_layer(norm, cc), nn.GELU())
        self.ch_adjust = conv(cc, out_ch, 1)
        self.down = nn.Sequential(
            conv(out_ch, out_ch, 3), norm_layer(norm, out_ch), nn.GELU(),
            ResConvBlock(out_ch, out_ch, is_res=True, use_se=use_se,
                         norm=norm, attn_reduction=attn_reduction,
                         use_pallas=use_pallas),
            conv(out_ch, out_ch, 4, stride=2))

    def forward(self, x):
        return self.down(self.ch_adjust(self.channel_compress(x)))


class UpsampleBilinear2x(nn.Module):
    """``nn.Upsample(scale_factor=2, mode='bilinear', align_corners=True)``."""

    def forward(self, x):
        return upsample_bilinear_align_corners_nchw(x, 2)


class UnetUp(nn.Module):
    """Up block (new_scripy.py:237-253): cat(x, skip) -> bilinear x2
    (align_corners=True) -> conv3x3 -> 2x ResConvBlock."""

    def __init__(self, in_ch: int, out_ch: int, norm: str = "group"):
        super().__init__()
        self.model = nn.Sequential(
            nn.Sequential(UpsampleBilinear2x(), conv(in_ch, out_ch, 3)),
            ResConvBlock(out_ch, out_ch, norm=norm),
            ResConvBlock(out_ch, out_ch, norm=norm))

    def forward(self, x, skip):
        return self.model(torch.cat([x, skip], dim=1))
