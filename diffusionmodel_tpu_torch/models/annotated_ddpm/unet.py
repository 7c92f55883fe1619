"""Textbook DDPM U-Net (the vendored labml design, reference/ddpm/unet.py),
counterpart of ``diffusionmodel_tpu/models/annotated_ddpm/unet.py``.

Sinusoidal time embedding (half_dim = n_channels // 8, log-10000 spacing,
then a Swish MLP), GroupNorm + Swish residual blocks with a time bias,
single-head self-attention over the H*W tokens, ``ch_mults`` levels with
``n_blocks`` blocks each and attention where ``is_attn`` says. The
structure is the JAX package's, which differs from labml's in two places:
a level's width is ``n_channels * mult`` (labml multiplies cumulatively)
and the extra up block of each level has no attention. GroupNorm uses
flax's epsilon (1e-6), every layer computes in float32.

Attribute names are labml's where the structure is the same:
``image_proj``, ``time_emb.lin1`` / ``lin2``, ``down.{k}.res.{norm1,
conv1,time_emb,norm2,conv2,shortcut}``, ``down.{k}.attn.{projection,
output}``, ``down.{k}.conv`` (downsample), ``middle.{res1,attn,res2}``,
``up.{k}.res`` / ``attn``, ``up.{k}.conv`` (upsample), ``norm``,
``final``. labml's AttentionBlock also holds a GroupNorm it never applies;
the JAX block has none, and neither has this one. ``compat.flax_bridge
.ddpm_unet_rules`` maps the names onto the JAX package's flax tree.

The attention is a plain softmax in PyTorch operations: the JAX block has
no flash path (its docstring's ``use_flash`` does not exist), so there is
no kernel to port. Public layout is [B,H,W,C], as the other denoisers.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn

from diffusionmodel_tpu_torch.nn.blocks import GroupNorm, channels_last, gn_groups

_EPS = 1e-6  # flax GroupNorm's default epsilon


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


class TimeEmbedding(nn.Module):
    """Sinusoidal t -> [B, n_channels] embedding + 2-layer Swish MLP."""

    def __init__(self, n_channels: int):
        super().__init__()
        self.n_channels = n_channels
        self.lin1 = nn.Linear(n_channels // 4, n_channels)
        self.lin2 = nn.Linear(n_channels, n_channels)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        half = self.n_channels // 8
        step = math.log(10_000) / (half - 1)
        freqs = torch.exp(torch.arange(half, dtype=torch.float32,
                                       device=t.device) * -step)
        ang = t.to(torch.float32)[:, None] * freqs[None, :]
        emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)
        return self.lin2(swish(self.lin1(emb)))


class ResidualBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, time_ch: int,
                 n_groups: int = 32, dropout: float = 0.1):
        super().__init__()
        self.norm1 = GroupNorm(gn_groups(in_ch, n_groups), in_ch, eps=_EPS)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.time_emb = nn.Linear(time_ch, out_ch)
        self.norm2 = GroupNorm(gn_groups(out_ch, n_groups), out_ch, eps=_EPS)
        self.dropout = nn.Dropout(dropout)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.shortcut = (nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch
                         else nn.Identity())

    def forward(self, x, t_emb):
        h = self.conv1(swish(self.norm1(x)))
        h = h + self.time_emb(swish(t_emb))[:, :, None, None]
        h = self.conv2(self.dropout(swish(self.norm2(h))))
        return channels_last(h + self.shortcut(x))


class AttentionBlock(nn.Module):
    """Multi-head self-attention over the flattened H*W tokens, residual
    added to the block's input."""

    def __init__(self, n_channels: int, n_heads: int = 1,
                 d_k: Optional[int] = None):
        super().__init__()
        self.n_heads = n_heads
        self.d_k = d_k or n_channels // n_heads
        self.projection = nn.Linear(n_channels, n_heads * self.d_k * 3)
        self.output = nn.Linear(n_heads * self.d_k, n_channels)
        self.scale = self.d_k ** -0.5

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = channels_last(x).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        qkv = self.projection(h).view(b, hh * ww, self.n_heads, 3 * self.d_k)
        q, k, v = torch.chunk(qkv, 3, dim=-1)
        attn = torch.einsum("bihd,bjhd->bijh", q, k) * self.scale
        attn = attn.softmax(dim=2)
        res = torch.einsum("bijh,bjhd->bihd", attn, v)
        res = self.output(res.reshape(b, hh * ww, self.n_heads * self.d_k))
        out = (res + h).reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        return channels_last(out)


class _ResAttn(nn.Module):
    """A residual block, with attention after it when ``has_attn``
    (labml's DownBlock / UpBlock)."""

    def __init__(self, in_ch: int, out_ch: int, time_ch: int,
                 has_attn: bool, dropout: float):
        super().__init__()
        self.res = ResidualBlock(in_ch, out_ch, time_ch, dropout=dropout)
        self.attn = AttentionBlock(out_ch) if has_attn else None

    def forward(self, x, t_emb):
        x = self.res(x, t_emb)
        return x if self.attn is None else self.attn(x)


class _Downsample(nn.Module):
    def __init__(self, n_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(n_channels, n_channels, 3, stride=2, padding=1)

    def forward(self, x, t_emb):
        return self.conv(x)


class _Upsample(nn.Module):
    """flax's ConvTranspose(4x4, stride 2, SAME) is PyTorch's padding 1."""

    def __init__(self, n_channels: int):
        super().__init__()
        self.conv = nn.ConvTranspose2d(n_channels, n_channels, 4, stride=2,
                                       padding=1)

    def forward(self, x, t_emb):
        return channels_last(self.conv(x))


class _Middle(nn.Module):
    def __init__(self, n_channels: int, time_ch: int, dropout: float):
        super().__init__()
        self.res1 = ResidualBlock(n_channels, n_channels, time_ch,
                                  dropout=dropout)
        self.attn = AttentionBlock(n_channels)
        self.res2 = ResidualBlock(n_channels, n_channels, time_ch,
                                  dropout=dropout)

    def forward(self, x, t_emb):
        return self.res2(self.attn(self.res1(x, t_emb)), t_emb)


class DdpmUNet(nn.Module):
    """U-Net with ``ch_mults`` levels, attention where ``is_attn``;
    ``forward(x [B,H,W,C], t [B] raw timesteps)``."""

    def __init__(self, image_channels: int = 3, n_channels: int = 64,
                 ch_mults: Sequence[int] = (1, 2, 2, 4),
                 is_attn: Sequence[bool] = (False, False, True, True),
                 n_blocks: int = 2, dropout: float = 0.1):
        super().__init__()
        self.layout = {"arch": "ddpm_unet", "ch_mults": tuple(ch_mults),
                       "is_attn": tuple(bool(a) for a in is_attn),
                       "n_blocks": n_blocks}
        time_ch = n_channels * 4
        self.image_proj = nn.Conv2d(image_channels, n_channels, 3, padding=1)
        self.time_emb = TimeEmbedding(time_ch)
        down, skips, ch = [], [n_channels], n_channels
        for i, mult in enumerate(ch_mults):
            out = n_channels * mult
            for _ in range(n_blocks):
                down.append(_ResAttn(ch, out, time_ch, is_attn[i], dropout))
                ch = out
                skips.append(ch)
            if i < len(ch_mults) - 1:
                down.append(_Downsample(ch))
                skips.append(ch)
        self.down = nn.ModuleList(down)
        self.middle = _Middle(ch, time_ch, dropout)
        up = []
        for i in reversed(range(len(ch_mults))):
            out = n_channels * ch_mults[i]
            for _ in range(n_blocks):
                up.append(_ResAttn(ch + skips.pop(), out, time_ch,
                                   is_attn[i], dropout))
                ch = out
            out = n_channels * (ch_mults[i - 1] if i > 0 else 1)
            up.append(_ResAttn(ch + skips.pop(), out, time_ch, False,
                               dropout))
            ch = out
            if i > 0:
                up.append(_Upsample(ch))
        self.up = nn.ModuleList(up)
        self.norm = GroupNorm(8, ch, eps=_EPS)
        self.final = nn.Conv2d(ch, image_channels, 3, padding=1)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        t = torch.as_tensor(t, device=x.device).reshape(-1)
        if t.shape[0] == 1 and x.shape[0] > 1:
            t = t.expand(x.shape[0])
        t_emb = self.time_emb(t)
        x = channels_last(self.image_proj(
            channels_last(x.permute(0, 3, 1, 2).float())))
        skips = [x]
        for m in self.down:
            x = m(x, t_emb)
            skips.append(x)
        x = self.middle(x, t_emb)
        for m in self.up:
            if isinstance(m, _Upsample):
                x = m(x, t_emb)
            else:
                x = m(channels_last(torch.cat([x, skips.pop()], dim=1)),
                      t_emb)
        x = self.final(swish(self.norm(x)))
        return channels_last(x).permute(0, 2, 3, 1)


class DdpmUNetAdapter(DdpmUNet):
    """:class:`DdpmUNet` behind the framework's denoiser interface
    ``(x, c, t, ctx_mask, attn_mask) -> eps`` (``arch="ddpm_unet"``), so
    the family trains and samples through the trainer, the samplers and
    the service. The labml model is unconditional: the class, context and
    attention inputs are ignored, and ``t`` is the raw timestep in
    [0, n_T) (the sinusoidal embedding expects exactly that)."""

    def forward(self, x, c=None, t=None, ctx_mask=None, attn_mask=None):
        return super().forward(x, t)
