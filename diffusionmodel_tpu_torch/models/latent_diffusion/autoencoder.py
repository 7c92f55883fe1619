"""Stable-Diffusion-style VAE (counterpart of
``diffusionmodel_tpu/models/latent_diffusion/autoencoder.py``).

Encoder: ``channels`` × ``ch_mults``, ``n_resnet`` ResnetBlocks a level,
a stride-2 downsample after every level but the last (pad (0,1,0,1), then a
VALID 3×3 conv), mid ResnetBlock-AttnBlock-ResnetBlock, GroupNorm + swish,
and a conv to 2·z moments. Decoder mirrors it with nearest ×2 upsampling.
``quant_conv`` / ``post_quant_conv`` sit between them and the latents.

Submodules carry the SD-v1 ``first_stage_model.*`` names
(``encoder.down.{i}.block.{j}.norm1``, ``decoder.mid.attn_1.q``,
``decoder.up.{i}.upsample.conv``, ``quant_conv``, …), which the JAX
package's ``compat/sd_convert.convert_sd_autoencoder`` reads. Public
layout is NHWC; inside, NCHW in channels_last memory. Norms use eps 1e-6.
``AttnBlock`` is a plain matmul-softmax: the JAX package computes it
outside Pallas too.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffusionmodel_tpu_torch.models.latent_diffusion.unet import (
    from_tokens,
    gn32,
    tokens,
)
from diffusionmodel_tpu_torch.nn.blocks import channels_last, to_nhwc


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = gn32(in_ch)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = gn32(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.nin_shortcut = (nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch
                             else nn.Identity())

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        return self.nin_shortcut(x) + h


class AttnBlock(nn.Module):
    """1×1-conv QKV self-attention over the H·W positions."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = gn32(channels)
        self.q = nn.Conv2d(channels, channels, 1)
        self.k = nn.Conv2d(channels, channels, 1)
        self.v = nn.Conv2d(channels, channels, 1)
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x):
        c, h, w = x.shape[1:]
        hn = self.norm(x)
        q, k, v = tokens(self.q(hn)), tokens(self.k(hn)), tokens(self.v(hn))
        attn = (torch.einsum("bic,bjc->bij", q, k) * c ** -0.5).softmax(-1)
        out = from_tokens(torch.einsum("bij,bjc->bic", attn, v), h, w)
        return x + self.proj_out(channels_last(out))


class Mid(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.block_1 = ResnetBlock(channels, channels)
        self.attn_1 = AttnBlock(channels)
        self.block_2 = ResnetBlock(channels, channels)

    def forward(self, x):
        return self.block_2(self.attn_1(self.block_1(x)))


class Resample(nn.Module):
    """``downsample.conv`` (pad right/bottom by 1, 3×3 stride-2 VALID) or
    ``upsample.conv`` (nearest ×2, 3×3)."""

    def __init__(self, channels: int, down: bool):
        super().__init__()
        self.down = down
        self.conv = nn.Conv2d(channels, channels, 3, stride=2 if down else 1,
                              padding=0 if down else 1)

    def forward(self, x):
        if self.down:
            return self.conv(channels_last(F.pad(x, (0, 1, 0, 1))))
        return self.conv(channels_last(
            F.interpolate(x, scale_factor=2, mode="nearest")))


class Level(nn.Module):
    def __init__(self, blocks, resample: Optional[Resample]):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        self.resample_name = None
        if resample is not None:
            self.resample_name = "downsample" if resample.down else "upsample"
            self.add_module(self.resample_name, resample)

    def forward(self, x):
        for blk in self.block:
            x = blk(x)
        if self.resample_name is None:
            return x
        return getattr(self, self.resample_name)(x)


class Encoder(nn.Module):
    def __init__(self, channels: int = 128,
                 ch_mults: Sequence[int] = (1, 2, 4, 4), n_resnet: int = 2,
                 z_channels: int = 4, in_channels: int = 3):
        super().__init__()
        self.conv_in = nn.Conv2d(in_channels, channels, 3, padding=1)
        ch = channels
        self.down = nn.ModuleList()
        for i, mult in enumerate(ch_mults):
            blocks = []
            for _ in range(n_resnet):
                blocks.append(ResnetBlock(ch, channels * mult))
                ch = channels * mult
            last = i == len(ch_mults) - 1
            self.down.append(Level(blocks,
                                   None if last else Resample(ch, True)))
        self.mid = Mid(ch)
        self.norm_out = gn32(ch)
        self.conv_out = nn.Conv2d(ch, 2 * z_channels, 3, padding=1)

    def forward(self, img):
        x = self.conv_in(img)
        for level in self.down:
            x = level(x)
        return self.conv_out(F.silu(self.norm_out(self.mid(x))))


class Decoder(nn.Module):
    def __init__(self, channels: int = 128,
                 ch_mults: Sequence[int] = (1, 2, 4, 4), n_resnet: int = 2,
                 out_channels: int = 3, z_channels: int = 4):
        super().__init__()
        ch = channels * ch_mults[-1]
        self.conv_in = nn.Conv2d(z_channels, ch, 3, padding=1)
        self.mid = Mid(ch)
        levels = [None] * len(ch_mults)
        for i in reversed(range(len(ch_mults))):
            blocks = []
            for _ in range(n_resnet + 1):
                blocks.append(ResnetBlock(ch, channels * ch_mults[i]))
                ch = channels * ch_mults[i]
            levels[i] = Level(blocks, Resample(ch, False) if i else None)
        self.up = nn.ModuleList(levels)
        self.norm_out = gn32(ch)
        self.conv_out = nn.Conv2d(ch, out_channels, 3, padding=1)

    def forward(self, z):
        x = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            x = level(x)
        return self.conv_out(F.silu(self.norm_out(x)))


class GaussianDistribution:
    """Moments [B,h,w,2·z] (NHWC) -> mean and log-variance (clamped to
    [-30, 20]); ``sample`` draws mean + std·noise."""

    def __init__(self, moments: torch.Tensor):
        self.mean, logvar = moments.chunk(2, dim=-1)
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)

    def sample(self, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``noise`` (any array of the mean's shape) when given, else a
        standard normal draw from ``generator``."""
        if noise is None:
            noise = torch.randn(self.mean.shape, generator=generator,
                                device=self.mean.device)
        else:
            noise = torch.as_tensor(noise, dtype=torch.float32,
                                    device=self.mean.device)
        return self.mean + self.std * noise


class Autoencoder(nn.Module):
    """``encode(img [B,H,W,3])`` -> GaussianDistribution over NHWC latents;
    ``decode(z [B,h,w,emb])`` -> images [B,H,W,3]."""

    def __init__(self, channels: int = 128,
                 ch_mults: Sequence[int] = (1, 2, 4, 4), z_channels: int = 4,
                 emb_channels: int = 4, n_resnet: int = 2):
        super().__init__()
        self.encoder = Encoder(channels, ch_mults, n_resnet, z_channels)
        self.decoder = Decoder(channels, ch_mults, n_resnet,
                               z_channels=z_channels)
        self.quant_conv = nn.Conv2d(2 * z_channels, 2 * emb_channels, 1)
        self.post_quant_conv = nn.Conv2d(emb_channels, z_channels, 1)

    def encode(self, img: torch.Tensor) -> GaussianDistribution:
        x = channels_last(img.permute(0, 3, 1, 2))
        return GaussianDistribution(
            to_nhwc(self.quant_conv(self.encoder(x))))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        x = channels_last(z.permute(0, 3, 1, 2))
        return to_nhwc(self.decoder(self.post_quant_conv(x)))
