"""The minimal 2-level MNIST ContextUnet (MNIST_script.py:119-187),
counterpart of ``diffusionmodel_tpu/nn/mnist_unet.py``.

28x28 -> down (14) -> down (7) -> AvgPool(7) + GELU -> ConvTranspose(7)
+ GN + ReLU -> up x2 with skips -> out. Down blocks are ResConvBlock +
MaxPool(2); up blocks ConvTranspose(2, stride 2) + 2x ResConvBlock.
Context masking uses the MNIST-style flip (MNIST_script.py:170): the kept
one-hot is multiplied by -1, dropped context is zeroed.

Public layout and compute type as ``nn/context_unet.py``: x [B,H,W,C] in,
[B,H,W,in_ch] out in ``dtype``, parameters float32, every layer from
``nn/blocks.py`` (so it rounds where the JAX package's bf16 program
rounds). Parameter names are the reference's, which
``diffusionmodel_tpu/compat/torch_convert.py::convert_mnist_unet`` reads
from ``state_dict()`` as it is. The default norm is BatchNorm, whose
running variance follows flax's (biased) rule.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffusionmodel_tpu_torch.nn.blocks import (
    ConvTranspose2d,
    EmbedFC,
    GroupNorm,
    ResConvBlock,
    channels_last,
    conv,
    gelu,
    gn_groups,
)


class _Down(nn.Module):
    """ResConvBlock + MaxPool(2) (MNIST_script.py:89-101)."""

    def __init__(self, in_ch: int, out_ch: int, norm: str,
                 dtype: torch.dtype):
        super().__init__()
        self.model = nn.Sequential(
            ResConvBlock(in_ch, out_ch, use_se=False, norm=norm, dtype=dtype),
            nn.MaxPool2d(2))

    def forward(self, x):
        return channels_last(self.model(x))


class _Up(nn.Module):
    """cat(x, skip) -> ConvTranspose(2, stride 2) -> 2x ResConvBlock
    (MNIST_script.py:103-117)."""

    def __init__(self, in_ch: int, out_ch: int, norm: str,
                 dtype: torch.dtype):
        super().__init__()
        self.model = nn.Sequential(
            ConvTranspose2d(in_ch, out_ch, 2, stride=2, compute_dtype=dtype),
            ResConvBlock(out_ch, out_ch, use_se=False, norm=norm,
                         dtype=dtype),
            ResConvBlock(out_ch, out_ch, use_se=False, norm=norm,
                         dtype=dtype))

    def forward(self, x, skip):
        return self.model(channels_last(torch.cat([x, skip], dim=1)))


class MnistContextUnet(nn.Module):
    layout = {"arch": "mnist_unet"}

    def __init__(self, in_ch: int = 1, n_feat: int = 128, n_classes: int = 10,
                 img_size: int = 28, norm: str = "batch",
                 mnist_style_ctx_flip: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        nf, dt = n_feat, dtype
        self.dtype = dt
        self.n_classes = n_classes
        self.pool = img_size // 4  # 28 -> 7 after two downs
        self.mnist_style_ctx_flip = mnist_style_ctx_flip
        self.init_conv = ResConvBlock(in_ch, nf, is_res=True, use_se=False,
                                      norm=norm, dtype=dt)
        self.down1 = _Down(nf, nf, norm, dt)
        self.down2 = _Down(nf, 2 * nf, norm, dt)
        self.timeembed1 = EmbedFC(1, 2 * nf, dt)
        self.timeembed2 = EmbedFC(1, nf, dt)
        self.contextembed1 = EmbedFC(n_classes, 2 * nf, dt)
        self.contextembed2 = EmbedFC(n_classes, nf, dt)
        self.up0 = nn.Sequential(
            ConvTranspose2d(2 * nf, 2 * nf, self.pool, stride=self.pool,
                            compute_dtype=dt),
            GroupNorm(gn_groups(2 * nf, 8), 2 * nf, compute_dtype=dt),
            nn.ReLU())
        self.up1 = _Up(4 * nf, nf, norm, dt)
        self.up2 = _Up(2 * nf, nf, norm, dt)
        self.out = nn.Sequential(
            conv(2 * nf, nf, 3, dtype=dt),
            GroupNorm(gn_groups(nf, 8), nf, compute_dtype=dt), nn.ReLU(),
            conv(nf, in_ch, 3, dtype=dt))

    def forward(self, x: torch.Tensor, c: torch.Tensor,
                t: Union[torch.Tensor, float], ctx_mask: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: [B,H,W,C]; c: [B] labels; t: [B] or scalar t/T; ctx_mask:
        [B] (1 = drop under the MNIST flip); ``attn_mask`` is ignored."""
        b, dt = x.shape[0], self.dtype
        x = channels_last(x.permute(0, 3, 1, 2))
        x0 = self.init_conv(x)
        down1 = self.down1(x0)
        down2 = self.down2(down1)
        hidden = gelu(F.avg_pool2d(down2, self.pool))

        classes = torch.arange(self.n_classes, device=x.device)
        c1h = (c.to(x.device)[:, None] == classes[None, :]).to(dt)
        m = torch.as_tensor(ctx_mask, device=x.device).to(dt)[:, None]
        if self.mnist_style_ctx_flip:
            m = -1.0 * (1.0 - m)
        cvec = c1h * m
        t = torch.as_tensor(t, device=x.device).to(dt).reshape(-1)
        if t.shape[0] == 1 and b > 1:
            t = t.expand(b)

        cemb1 = self.contextembed1(cvec)[:, :, None, None]
        temb1 = self.timeembed1(t[:, None])[:, :, None, None]
        cemb2 = self.contextembed2(cvec)[:, :, None, None]
        temb2 = self.timeembed2(t[:, None])[:, :, None, None]

        up1 = self.up0(hidden)
        up2 = self.up1(cemb1 * up1 + temb1, down2)
        up3 = self.up2(cemb2 * up2 + temb2, down1)
        out = self.out(channels_last(torch.cat([up3, x0], dim=1)))
        return channels_last(out).permute(0, 2, 3, 1)
