"""Stable-Diffusion-style conditional U-Net (counterpart of
``diffusionmodel_tpu/models/latent_diffusion/unet.py``).

UNetModel: base channels × multipliers, SpatialTransformers at the chosen
levels, a sinusoidal time embedding (cos before sin). SpatialTransformer =
GroupNorm + 1×1 in/out projections around pre-LayerNorm blocks of
self-attention → cross-attention(cond) → GeGLU feed-forward.

SD-v1 takes one depth and one head count for every level. SDXL (sgm's
``sd_xl_base.yaml``) adds what its UNet needs: a depth per level, the
middle taking the last level's (``tf_layers=(0, 2, 10)``); heads set by a
head width (``d_head=64``: 10 heads at 640 channels, 20 at 1280); Linear
in/out projections on the [B, H·W, C] tokens after the GroupNorm
(``linear_proj``); and a vector condition ``y`` (``adm_in_channels``)
through ``label_emb`` (Linear, SiLU, Linear), added to the time embedding.

Submodules carry the SD-v1 checkpoint's names (``time_embed.0``,
``input_blocks.{i}.0.in_layers.0``, ``…transformer_blocks.0.attn1.to_q``,
``output_blocks.{i}.{1|2}.conv``, ``out.2``, …): a real
``model.diffusion_model.*`` state dict loads after stripping that prefix,
and the JAX package's ``compat/sd_convert.convert_sd_unet`` reads this
module's ``state_dict()`` as it is.

Public layout is the JAX package's: NHWC latents, integer ``t`` [B],
conditioning [B, M, d_cond], or with a vector condition the pair
(context [B, M, d_cond], y [B, adm_in_channels]). Inside, tensors are
NCHW in channels_last memory, so a feature map viewed as [B, H·W, C]
tokens is free. Every norm uses eps 1e-6 (flax's default) and ``32 if C %
32 == 0 else 1`` groups.

Self-attention goes through :func:`kernels.flash_attn.flash_attention`
(the CUDA kernel for CUDA tensors) when ``use_flash`` is set and the
sequence has at least ``flash_min_seq`` tokens: the JAX package's gate,
set from TPU measurements (2048); the ``sdxl`` arch takes 1024, measured
on the card. Cross-attention (M = 77) is always the plain einsum-softmax.

With ``tracing`` on, every SpatialTransformer call is an
``ldm.transformer`` span (ids ``tokens``, ``depth``) and every
self-attention adds one to ``ldm.attn_flash_calls`` or
``ldm.attn_plain_calls``, by the path it took.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffusionmodel_tpu_torch import tracing
from diffusionmodel_tpu_torch.kernels.flash_attn import flash_attention
from diffusionmodel_tpu_torch.nn.blocks import GroupNorm, channels_last, to_nhwc

LDM_EPS = 1e-6  # flax GroupNorm / LayerNorm default


def gn32(channels: int) -> GroupNorm:
    return GroupNorm(32 if channels % 32 == 0 else 1, channels, eps=LDM_EPS)


def time_frequencies(channels: int, max_period: int = 10000,
                     device=None) -> torch.Tensor:
    """The embedding's ``channels // 2`` float32 frequencies,
    ``exp(-log(max_period) * k / half)``."""
    half = channels // 2
    return torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=device) / half)


def sinusoidal_time_emb(t: torch.Tensor, channels: int,
                        max_period: int = 10000) -> torch.Tensor:
    freqs = time_frequencies(channels, max_period, t.device)
    ang = t.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def tokens(x: torch.Tensor) -> torch.Tensor:
    """[B,C,H,W] channels_last -> [B, H·W, C] (a view when the memory is
    channels_last)."""
    b, c, h, w = x.shape
    return to_nhwc(x).reshape(b, h * w, c)


def from_tokens(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, H·W, C] -> [B,C,H,W] view in channels_last memory."""
    return x.reshape(x.shape[0], h, w, x.shape[-1]).permute(0, 3, 1, 2)


class CrossAttention(nn.Module):
    """QKV attention; self-attention when ``cond`` is None."""

    def __init__(self, d_model: int, n_heads: int, d_head: int,
                 d_cond: Optional[int] = None, use_flash: bool = True,
                 flash_min_seq: int = 2048):
        super().__init__()
        inner = n_heads * d_head
        self.n_heads, self.d_head = n_heads, d_head
        self.use_flash, self.flash_min_seq = use_flash, flash_min_seq
        self.to_q = nn.Linear(d_model, inner, bias=False)
        self.to_k = nn.Linear(d_cond or d_model, inner, bias=False)
        self.to_v = nn.Linear(d_cond or d_model, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, d_model))

    def forward(self, x, cond=None):
        c = x if cond is None else cond
        b, n, _ = x.shape
        m = c.shape[1]
        q = self.to_q(x).view(b, n, self.n_heads, self.d_head)
        k = self.to_k(c).view(b, m, self.n_heads, self.d_head)
        v = self.to_v(c).view(b, m, self.n_heads, self.d_head)
        flash = self.use_flash and cond is None and n >= self.flash_min_seq
        if cond is None:
            tracing.count("ldm.attn_flash_calls" if flash
                          else "ldm.attn_plain_calls")
        if flash:
            out = flash_attention(q, k, v)
        else:
            attn = torch.einsum("bihd,bjhd->bhij", q, k) * self.d_head ** -0.5
            out = torch.einsum("bhij,bjhd->bihd", attn.softmax(dim=-1), v)
        return self.to_out(out.reshape(b, n, self.n_heads * self.d_head))


class GeGLU(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.proj = nn.Linear(d_in, d_out * 2)

    def forward(self, x):
        x, gate = self.proj(x).chunk(2, dim=-1)
        return x * F.gelu(gate)


class FeedForward(nn.Module):
    """``net.0.proj`` (GeGLU) -> ``net.2`` (Linear), the SD names."""

    def __init__(self, d_model: int):
        super().__init__()
        self.net = nn.Sequential(GeGLU(d_model, d_model * 4), nn.Identity(),
                                 nn.Linear(d_model * 4, d_model))

    def forward(self, x):
        return self.net(x)


class BasicTransformerBlock(nn.Module):
    def __init__(self, d_model: int, n_heads: int, d_head: int, d_cond: int,
                 use_flash: bool = True, flash_min_seq: int = 2048):
        super().__init__()
        self.attn1 = CrossAttention(d_model, n_heads, d_head, None,
                                    use_flash, flash_min_seq)
        self.attn2 = CrossAttention(d_model, n_heads, d_head, d_cond)
        self.norm1 = nn.LayerNorm(d_model, eps=LDM_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LDM_EPS)
        self.norm3 = nn.LayerNorm(d_model, eps=LDM_EPS)
        self.ff = FeedForward(d_model)

    def forward(self, x, cond):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), cond)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """GroupNorm, in-projection, ``n_layers`` blocks, out-projection, plus
    the input. The projections are 1×1 convolutions on the map (SD-v1) or,
    with ``linear``, Linear layers on the tokens (SDXL)."""

    def __init__(self, channels: int, n_heads: int, n_layers: int = 1,
                 d_cond: int = 768, use_flash: bool = True,
                 flash_min_seq: int = 2048, linear: bool = False):
        super().__init__()
        self.linear = linear

        def proj():
            return (nn.Linear(channels, channels) if linear
                    else nn.Conv2d(channels, channels, 1))

        self.norm = gn32(channels)
        self.proj_in = proj()
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(channels, n_heads, channels // n_heads,
                                  d_cond, use_flash, flash_min_seq)
            for _ in range(n_layers))
        self.proj_out = proj()

    def forward(self, x, cond):
        h, w = x.shape[2:]
        with tracing.span("ldm.transformer", tokens=h * w,
                          depth=len(self.transformer_blocks)):
            if self.linear:
                t = self.proj_in(tokens(self.norm(x)))
            else:
                t = tokens(self.proj_in(self.norm(x)))
            for block in self.transformer_blocks:
                t = block(t, cond)
            if self.linear:
                return from_tokens(self.proj_out(t), h, w) + x
            return self.proj_out(from_tokens(t, h, w)) + x


class ResBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, d_emb: int):
        super().__init__()
        self.in_layers = nn.Sequential(gn32(in_ch), nn.SiLU(),
                                       nn.Conv2d(in_ch, out_ch, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(d_emb, out_ch))
        self.out_layers = nn.Sequential(gn32(out_ch), nn.SiLU(), nn.Identity(),
                                        nn.Conv2d(out_ch, out_ch, 3,
                                                  padding=1))
        self.skip_connection = (nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch
                                else nn.Identity())

    def forward(self, x, emb):
        h = self.in_layers(x) + self.emb_layers(emb)[:, :, None, None]
        return self.skip_connection(x) + self.out_layers(h)


class Downsample(nn.Module):
    """3×3 stride-2 conv, padding 1 on every side."""

    def __init__(self, channels: int):
        super().__init__()
        self.op = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    """Nearest ×2, then a 3×3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(channels_last(
            F.interpolate(x, scale_factor=2, mode="nearest")))


class Stage(nn.ModuleList):
    """One ``input_blocks`` / ``output_blocks`` entry: layers in order, each
    given what it takes (the time embedding, the conditioning or neither)."""

    def forward(self, x, emb, cond):
        for layer in self:
            if isinstance(layer, ResBlock):
                x = layer(x, emb)
            elif isinstance(layer, SpatialTransformer):
                x = layer(x, cond)
            else:
                x = layer(x)
        return x


class UNetModel(nn.Module):
    """Latent-space eps-predictor with text cross-attention.

    ``forward(x [B,h,w,in_channels], t [B] int, cond)`` -> eps
    [B,h,w,out_channels]; ``cond`` is the context [B,M,d_cond], or with
    ``adm_in_channels`` the pair (context, y [B, adm_in_channels]).

    ``tf_layers`` is the transformer depth of every level and the middle
    (an int), or of each level, the middle taking the last level's (a
    sequence). Heads: ``n_heads`` at every level, or with ``d_head`` as
    many as the level's channels over ``d_head``."""

    def __init__(self, in_channels: int = 4, out_channels: int = 4,
                 channels: int = 320, n_res_blocks: int = 2,
                 attention_levels: Sequence[int] = (0, 1, 2),
                 channel_multipliers: Sequence[int] = (1, 2, 4, 4),
                 n_heads: int = 8, tf_layers: Union[int, Sequence[int]] = 1,
                 d_cond: int = 768, use_flash: bool = True,
                 flash_min_seq: int = 2048, d_head: Optional[int] = None,
                 linear_proj: bool = False,
                 adm_in_channels: Optional[int] = None):
        super().__init__()
        self.channels = channels
        d_emb = channels * 4
        n_levels = len(channel_multipliers)
        depth = ([tf_layers] * n_levels if isinstance(tf_layers, int)
                 else list(tf_layers))

        def attn(ch, level):
            return SpatialTransformer(
                ch, ch // d_head if d_head else n_heads, depth[level],
                d_cond, use_flash, flash_min_seq, linear_proj)

        self.time_embed = nn.Sequential(nn.Linear(channels, d_emb), nn.SiLU(),
                                        nn.Linear(d_emb, d_emb))
        self.label_emb = None
        if adm_in_channels:
            self.label_emb = nn.Sequential(nn.Sequential(
                nn.Linear(adm_in_channels, d_emb), nn.SiLU(),
                nn.Linear(d_emb, d_emb)))
        self.input_blocks = nn.ModuleList(
            [Stage([nn.Conv2d(in_channels, channels, 3, padding=1)])])
        skip_ch = [channels]
        ch = channels
        for i, mult in enumerate(channel_multipliers):
            for _ in range(n_res_blocks):
                layers = [ResBlock(ch, channels * mult, d_emb)]
                ch = channels * mult
                if i in attention_levels:
                    layers.append(attn(ch, i))
                self.input_blocks.append(Stage(layers))
                skip_ch.append(ch)
            if i != n_levels - 1:
                self.input_blocks.append(Stage([Downsample(ch)]))
                skip_ch.append(ch)
        self.middle_block = Stage([ResBlock(ch, ch, d_emb),
                                   attn(ch, n_levels - 1),
                                   ResBlock(ch, ch, d_emb)])
        self.output_blocks = nn.ModuleList()
        for i in reversed(range(n_levels)):
            for j in range(n_res_blocks + 1):
                out = channels * channel_multipliers[i]
                layers = [ResBlock(ch + skip_ch.pop(), out, d_emb)]
                ch = out
                if i in attention_levels:
                    layers.append(attn(ch, i))
                if i != 0 and j == n_res_blocks:
                    layers.append(Upsample(ch))
                self.output_blocks.append(Stage(layers))
        self.out = nn.Sequential(gn32(ch), nn.SiLU(),
                                 nn.Conv2d(ch, out_channels, 3, padding=1))

    def set_use_flash(self, flag: bool) -> None:
        """Turn the flash gate of every self-attention on or off."""
        for mod in self.modules():
            if isinstance(mod, CrossAttention):
                mod.use_flash = flag

    def forward(self, x, t, cond):
        cond, y = cond if isinstance(cond, tuple) else (cond, None)
        if (y is None) != (self.label_emb is None):
            raise ValueError("the vector condition y is given if and only "
                             "if the model has adm_in_channels")
        emb = self.time_embed(sinusoidal_time_emb(t, self.channels))
        if y is not None:
            emb = emb + self.label_emb(y)
        x = channels_last(x.permute(0, 3, 1, 2))
        skips = []
        for stage in self.input_blocks:
            x = stage(x, emb, cond)
            skips.append(x)
        x = self.middle_block(x, emb, cond)
        for stage in self.output_blocks:
            x = stage(channels_last(torch.cat([x, skips.pop()], dim=1)), emb,
                      cond)
        return to_nhwc(self.out(x))
