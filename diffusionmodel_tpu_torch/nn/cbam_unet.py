"""The v1.5 CBAM variant (custom_dataset.py:17-252), counterpart of
``diffusionmodel_tpu/nn/cbam_unet.py``.

4-level U-Net with CBAM (channel + spatial attention) after each down
block: simpler down blocks than v2 (ResConv + conv4x4 s2 + GN(8) + GELU,
custom_dataset.py:98-113), ConvTranspose(2, stride 2) up blocks, down4
(S/16) pooled to a 1x1 hidden with ``AvgPool(min(8, S/16))`` and up0 a
ConvTranspose of that kernel. The LocalEnhancer (ReLU form,
custom_dataset.py:160) takes the spatial attention mask (quirk Q3) and is
the identity without one.

Public layout and compute type as ``nn/context_unet.py``; parameter names
are the reference's (``down1.model.0``, ``cbam1.channel_attention.
shared_MLP.0``, ``cbam1.spatial_attention.conv2d``, ``up1.model.0`` ...),
which ``diffusionmodel_tpu/compat/torch_convert.py::convert_cbam_unet``
reads from ``state_dict()`` as it is. CBAM has no kernel: it runs as
PyTorch operations (the JAX package's has no Pallas path either).
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffusionmodel_tpu_torch.nn.blocks import (
    ConvTranspose2d,
    EmbedFC,
    GELU,
    GroupNorm,
    LocalEnhancer,
    ResConvBlock,
    channels_last,
    conv,
    gelu,
    gn_groups,
    sigmoid,
)

_F32 = torch.float32


def _mean(x: torch.Tensor, dim, dtype: torch.dtype) -> torch.Tensor:
    """Mean taken in float32 and rounded to ``dtype`` (``jnp.mean`` of a
    bf16 array)."""
    return x.float().mean(dim=dim, keepdim=True).to(dtype)


class ChannelAttention(nn.Module):
    """avg + max pool -> shared 1x1-conv MLP (no bias) -> sigmoid
    (custom_dataset.py:17-33)."""

    def __init__(self, channels: int, ratio: int = 16,
                 dtype: torch.dtype = _F32):
        super().__init__()
        red = max(1, channels // ratio)
        self.dtype = dtype
        self.shared_MLP = nn.Sequential(
            conv(channels, red, 1, bias=False, dtype=dtype), nn.ReLU(),
            conv(red, channels, 1, bias=False, dtype=dtype))

    def forward(self, x):
        avg = _mean(x, (2, 3), self.dtype)
        mx = torch.amax(x, dim=(2, 3), keepdim=True)
        return sigmoid(self.shared_MLP(avg) + self.shared_MLP(mx))


class SpatialAttention(nn.Module):
    """channel mean / max cat -> 7x7 conv -> sigmoid
    (custom_dataset.py:35-46)."""

    def __init__(self, dtype: torch.dtype = _F32):
        super().__init__()
        self.dtype = dtype
        self.conv2d = conv(2, 1, 7, dtype=dtype)

    def forward(self, x):
        avg = _mean(x, 1, self.dtype)
        mx = torch.amax(x, dim=1, keepdim=True)
        return sigmoid(self.conv2d(channels_last(torch.cat([avg, mx], 1))))


class CBAM(nn.Module):
    def __init__(self, channels: int, dtype: torch.dtype = _F32):
        super().__init__()
        self.channel_attention = ChannelAttention(channels, dtype=dtype)
        self.spatial_attention = SpatialAttention(dtype=dtype)

    def forward(self, x):
        x = self.channel_attention(x) * x
        return channels_last(self.spatial_attention(x) * x)


class _Down(nn.Module):
    """ResConv + conv4x4 s2 + GN(8) + GELU (custom_dataset.py:98-113)."""

    def __init__(self, in_ch: int, out_ch: int, norm: str = "group",
                 dtype: torch.dtype = _F32):
        super().__init__()
        self.model = nn.Sequential(
            ResConvBlock(in_ch, out_ch, use_se=False, norm=norm, dtype=dtype),
            conv(out_ch, out_ch, 4, stride=2, dtype=dtype),
            GroupNorm(gn_groups(out_ch, 8), out_ch, compute_dtype=dtype),
            GELU())

    def forward(self, x):
        return self.model(x)


class _Up(nn.Module):
    """cat -> ConvTranspose(2, stride 2) -> 2x ResConv
    (custom_dataset.py:116-132)."""

    def __init__(self, in_ch: int, out_ch: int, norm: str = "group",
                 dtype: torch.dtype = _F32):
        super().__init__()
        self.model = nn.Sequential(
            ConvTranspose2d(in_ch, out_ch, 2, stride=2, compute_dtype=dtype),
            ResConvBlock(out_ch, out_ch, use_se=False, norm=norm,
                         dtype=dtype),
            ResConvBlock(out_ch, out_ch, use_se=False, norm=norm,
                         dtype=dtype))

    def forward(self, x, skip):
        return self.model(channels_last(torch.cat([x, skip], dim=1)))


class CbamContextUnet(nn.Module):
    layout = {"arch": "cbam_unet"}

    def __init__(self, in_ch: int = 3, n_feat: int = 128, n_classes: int = 10,
                 img_size: int = 128, norm: str = "group",
                 high_thresh: float = 1.2, dtype: torch.dtype = _F32):
        super().__init__()
        nf, dt = n_feat, dtype
        d4 = img_size // 16
        pool = min(8, d4)
        if img_size % 16 or d4 % pool:
            raise ValueError("img_size must be a multiple of 16")
        self.dtype, self.pool, self.n_classes = dt, pool, n_classes
        self.init_conv = ResConvBlock(in_ch, nf, is_res=True, use_se=False,
                                      norm=norm, dtype=dt)
        chans = [nf, 2 * nf, 4 * nf, 8 * nf]
        in_chans = [nf, nf, 2 * nf, 4 * nf]
        for i, (ci, co) in enumerate(zip(in_chans, chans)):
            self.add_module(f"down{i + 1}", _Down(ci, co, norm, dt))
            self.add_module(f"cbam{i + 1}", CBAM(co, dt))
        self.contextembed1 = EmbedFC(n_classes, 8 * nf, dt)
        self.contextembed2 = EmbedFC(n_classes, 4 * nf, dt)
        self.timeembed1 = EmbedFC(1, 8 * nf, dt)
        self.timeembed2 = EmbedFC(1, 4 * nf, dt)
        self.up0 = nn.Sequential(
            ConvTranspose2d(8 * nf, 8 * nf, pool, stride=pool,
                            compute_dtype=dt),
            GroupNorm(gn_groups(8 * nf, 8), 8 * nf, compute_dtype=dt),
            nn.ReLU())
        self.up1 = _Up(16 * nf, 4 * nf, norm, dt)
        self.up2 = _Up(8 * nf, 2 * nf, norm, dt)
        self.up3 = _Up(4 * nf, nf, norm, dt)
        self.up4 = _Up(2 * nf, nf, norm, dt)
        self.local_enhance = LocalEnhancer(nf, high_thresh, act="relu",
                                           dtype=dt)
        self.out = nn.Sequential(
            conv(2 * nf, nf, 3, dtype=dt),
            GroupNorm(gn_groups(nf, 8), nf, compute_dtype=dt), nn.ReLU(),
            conv(nf, in_ch, 3, dtype=dt))

    def forward(self, x: torch.Tensor, c: torch.Tensor,
                t: Union[torch.Tensor, float], ctx_mask: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: [B,H,W,C]; c: [B] labels; t: [B] or scalar t/T; ctx_mask:
        [B] (1 = keep context); attn_mask: optional [B,H,W]."""
        b, dt = x.shape[0], self.dtype
        x = channels_last(x.permute(0, 3, 1, 2))
        x0 = self.init_conv(x)
        downs, h = [], x0
        for i in range(1, 5):
            h = getattr(self, f"cbam{i}")(getattr(self, f"down{i}")(h))
            downs.append(h)
        down1, down2, down3, down4 = downs
        hidden = gelu(F.avg_pool2d(down4, self.pool))

        classes = torch.arange(self.n_classes, device=x.device)
        c1h = (c.to(x.device)[:, None] == classes[None, :]).to(dt)
        cvec = c1h * torch.as_tensor(ctx_mask, device=x.device).to(dt)[:, None]
        t = torch.as_tensor(t, device=x.device).to(dt).reshape(-1)
        if t.shape[0] == 1 and b > 1:
            t = t.expand(b)

        cemb1 = self.contextembed1(cvec)[:, :, None, None]
        temb1 = self.timeembed1(t[:, None])[:, :, None, None]
        cemb2 = self.contextembed2(cvec)[:, :, None, None]
        temb2 = self.timeembed2(t[:, None])[:, :, None, None]

        up1 = self.up0(hidden)
        up2 = self.up1(cemb1 * up1 + temb1, down4)
        up3 = self.up2(cemb2 * up2 + temb2, down3)
        up4 = self.up3(up3, down2)
        up5 = self.local_enhance(self.up4(up4, down1), attn_mask)
        out = self.out(channels_last(torch.cat([up5, x0], dim=1)))
        return channels_last(out).permute(0, 2, 3, 1)
