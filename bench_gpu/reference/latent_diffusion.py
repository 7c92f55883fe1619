"""Plain float32 Stable Diffusion v1 (CompVis stable-diffusion,
``configs/stable-diffusion/v1-inference.yaml``): the latent UNet (320
channels, multipliers 1,2,4,4, two ResBlocks a level, one transformer
block with self-attention, cross-attention to a [B, 77, 768] context and
a GeGLU feed-forward at levels 0-2, 8 heads), the f=8 VAE (128 channels,
multipliers 1,2,4,4, z 4), the scaled-linear schedule (0.00085 to 0.012,
1000 steps, latents scaled by 0.18215), DPM-Solver++(2M) with guidance
in the standard orientation, the simplified eps loss with conditioning
dropout, and the no-CLIP prompt-hash context.

Written in plain ``torch``: every attention is a softmax over explicit
scores, no kernels, no bf16. Parameter names are the SD-v1 checkpoint's,
so the benchmark's seeded weights fill this module and the program's alike.
``quant`` has no use here: the control of a float32 configuration is this
reference with TF32 allowed (``lowp.tf32_allowed``).
"""

from __future__ import annotations

import hashlib
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

EPS = 1e-6
SCALE = 0.18215


def gn32(c: int) -> nn.GroupNorm:
    return nn.GroupNorm(32 if c % 32 == 0 else 1, c, eps=EPS)


def time_embedding(t: torch.Tensor, channels: int) -> torch.Tensor:
    half = channels // 2
    freqs = torch.exp(-math.log(10000) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    ang = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def _tokens(x):
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w, c)


def _map(t, h, w):
    return t.reshape(t.shape[0], h, w, t.shape[-1]).permute(0, 3, 1, 2)


class CrossAttention(nn.Module):
    def __init__(self, d: int, heads: int, d_head: int, d_cond=None):
        super().__init__()
        inner = heads * d_head
        self.heads, self.d_head = heads, d_head
        self.to_q = nn.Linear(d, inner, bias=False)
        self.to_k = nn.Linear(d_cond or d, inner, bias=False)
        self.to_v = nn.Linear(d_cond or d, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, d))

    def forward(self, x, cond=None):
        c = x if cond is None else cond
        b, n, _ = x.shape
        q = self.to_q(x).view(b, n, self.heads, self.d_head).transpose(1, 2)
        k = self.to_k(c).view(b, -1, self.heads, self.d_head).transpose(1, 2)
        v = self.to_v(c).view(b, -1, self.heads, self.d_head).transpose(1, 2)
        out = []
        for i in range(b):  # one sample's scores at a time: [h, n, m]
            s = (q[i] @ k[i].transpose(1, 2)) * self.d_head ** -0.5
            out.append(s.softmax(dim=-1) @ v[i])
        out = torch.stack(out).transpose(1, 2).reshape(b, n, -1)
        return self.to_out(out)


class GeGLU(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.proj = nn.Linear(d_in, 2 * d_out)

    def forward(self, x):
        x, gate = self.proj(x).chunk(2, dim=-1)
        return x * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.net = nn.Sequential(GeGLU(d, 4 * d), nn.Identity(),
                                 nn.Linear(4 * d, d))

    def forward(self, x):
        return self.net(x)


class TransformerBlock(nn.Module):
    def __init__(self, d: int, heads: int, d_cond: int):
        super().__init__()
        self.attn1 = CrossAttention(d, heads, d // heads)
        self.attn2 = CrossAttention(d, heads, d // heads, d_cond)
        self.norm1 = nn.LayerNorm(d, eps=EPS)
        self.norm2 = nn.LayerNorm(d, eps=EPS)
        self.norm3 = nn.LayerNorm(d, eps=EPS)
        self.ff = FeedForward(d)

    def forward(self, x, cond):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), cond)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    def __init__(self, c: int, heads: int, d_cond: int):
        super().__init__()
        self.norm = gn32(c)
        self.proj_in = nn.Conv2d(c, c, 1)
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(c, heads, d_cond)])
        self.proj_out = nn.Conv2d(c, c, 1)

    def forward(self, x, cond):
        h, w = x.shape[2:]
        t = _tokens(self.proj_in(self.norm(x)))
        for blk in self.transformer_blocks:
            t = blk(t, cond)
        return self.proj_out(_map(t, h, w)) + x


class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, d_emb: int):
        super().__init__()
        self.in_layers = nn.Sequential(gn32(cin), nn.SiLU(),
                                       nn.Conv2d(cin, cout, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(d_emb, cout))
        self.out_layers = nn.Sequential(gn32(cout), nn.SiLU(), nn.Identity(),
                                        nn.Conv2d(cout, cout, 3, padding=1))
        self.skip_connection = (nn.Conv2d(cin, cout, 1) if cin != cout
                                else nn.Identity())

    def forward(self, x, emb):
        h = self.in_layers(x) + self.emb_layers(emb)[:, :, None, None]
        return self.skip_connection(x) + self.out_layers(h)


class Down(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.op = nn.Conv2d(c, c, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class Up(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class Stage(nn.ModuleList):
    def forward(self, x, emb, cond):
        for layer in self:
            if isinstance(layer, ResBlock):
                x = layer(x, emb)
            elif isinstance(layer, SpatialTransformer):
                x = layer(x, cond)
            else:
                x = layer(x)
        return x


class UNet(nn.Module):
    """x [B,h,w,4], t [B] int, cond [B,M,768] -> eps [B,h,w,4]."""

    def __init__(self, channels=320, mults: Sequence[int] = (1, 2, 4, 4),
                 attn_levels: Sequence[int] = (0, 1, 2), n_res: int = 2,
                 heads: int = 8, d_cond: int = 768, zc: int = 4):
        super().__init__()
        self.channels = channels
        d_emb = 4 * channels
        self.time_embed = nn.Sequential(nn.Linear(channels, d_emb),
                                        nn.SiLU(), nn.Linear(d_emb, d_emb))
        self.input_blocks = nn.ModuleList(
            [Stage([nn.Conv2d(zc, channels, 3, padding=1)])])
        skips, ch = [channels], channels
        for i, m in enumerate(mults):
            for _ in range(n_res):
                layers = [ResBlock(ch, channels * m, d_emb)]
                ch = channels * m
                if i in attn_levels:
                    layers.append(SpatialTransformer(ch, heads, d_cond))
                self.input_blocks.append(Stage(layers))
                skips.append(ch)
            if i != len(mults) - 1:
                self.input_blocks.append(Stage([Down(ch)]))
                skips.append(ch)
        self.middle_block = Stage([ResBlock(ch, ch, d_emb),
                                   SpatialTransformer(ch, heads, d_cond),
                                   ResBlock(ch, ch, d_emb)])
        self.output_blocks = nn.ModuleList()
        for i in reversed(range(len(mults))):
            for j in range(n_res + 1):
                out = channels * mults[i]
                layers = [ResBlock(ch + skips.pop(), out, d_emb)]
                ch = out
                if i in attn_levels:
                    layers.append(SpatialTransformer(ch, heads, d_cond))
                if i and j == n_res:
                    layers.append(Up(ch))
                self.output_blocks.append(Stage(layers))
        self.out = nn.Sequential(gn32(ch), nn.SiLU(),
                                 nn.Conv2d(ch, zc, 3, padding=1))

    def forward(self, x, t, cond):
        emb = self.time_embed(time_embedding(t, self.channels))
        x = x.permute(0, 3, 1, 2)
        hs = []
        for stage in self.input_blocks:
            x = stage(x, emb, cond)
            hs.append(x)
        x = self.middle_block(x, emb, cond)
        for stage in self.output_blocks:
            x = stage(torch.cat([x, hs.pop()], dim=1), emb, cond)
        return self.out(x).permute(0, 2, 3, 1)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1, self.conv1 = gn32(cin), nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = gn32(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.nin_shortcut = (nn.Conv2d(cin, cout, 1) if cin != cout
                             else nn.Identity())

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        return self.nin_shortcut(x) + self.conv2(F.silu(self.norm2(h)))


class AttnBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.norm = gn32(c)
        self.q, self.k = nn.Conv2d(c, c, 1), nn.Conv2d(c, c, 1)
        self.v, self.proj_out = nn.Conv2d(c, c, 1), nn.Conv2d(c, c, 1)

    def forward(self, x):
        c, h, w = x.shape[1:]
        n = self.norm(x)
        q, k, v = _tokens(self.q(n)), _tokens(self.k(n)), _tokens(self.v(n))
        a = ((q @ k.transpose(1, 2)) * c ** -0.5).softmax(dim=-1)
        return x + self.proj_out(_map(a @ v, h, w))


class Mid(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.block_1, self.attn_1 = ResnetBlock(c, c), AttnBlock(c)
        self.block_2 = ResnetBlock(c, c)

    def forward(self, x):
        return self.block_2(self.attn_1(self.block_1(x)))


class Resample(nn.Module):
    def __init__(self, c: int, down: bool):
        super().__init__()
        self.down = down
        self.conv = nn.Conv2d(c, c, 3, stride=2 if down else 1,
                              padding=0 if down else 1)

    def forward(self, x):
        if self.down:
            return self.conv(F.pad(x, (0, 1, 0, 1)))
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class Level(nn.Module):
    def __init__(self, blocks, resample=None):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        self.rs = None
        if resample is not None:
            self.rs = "downsample" if resample.down else "upsample"
            self.add_module(self.rs, resample)

    def forward(self, x):
        for b in self.block:
            x = b(x)
        return x if self.rs is None else getattr(self, self.rs)(x)


class Encoder(nn.Module):
    def __init__(self, ch=128, mults=(1, 2, 4, 4), n_res=2, zc=4):
        super().__init__()
        self.conv_in = nn.Conv2d(3, ch, 3, padding=1)
        c, self.down = ch, nn.ModuleList()
        for i, m in enumerate(mults):
            blocks = []
            for _ in range(n_res):
                blocks.append(ResnetBlock(c, ch * m))
                c = ch * m
            self.down.append(Level(blocks, None if i == len(mults) - 1
                                   else Resample(c, True)))
        self.mid = Mid(c)
        self.norm_out = gn32(c)
        self.conv_out = nn.Conv2d(c, 2 * zc, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for lv in self.down:
            x = lv(x)
        return self.conv_out(F.silu(self.norm_out(self.mid(x))))


class Decoder(nn.Module):
    def __init__(self, ch=128, mults=(1, 2, 4, 4), n_res=2, zc=4):
        super().__init__()
        c = ch * mults[-1]
        self.conv_in = nn.Conv2d(zc, c, 3, padding=1)
        self.mid = Mid(c)
        levels = [None] * len(mults)
        for i in reversed(range(len(mults))):
            blocks = []
            for _ in range(n_res + 1):
                blocks.append(ResnetBlock(c, ch * mults[i]))
                c = ch * mults[i]
            levels[i] = Level(blocks, Resample(c, False) if i else None)
        self.up = nn.ModuleList(levels)
        self.norm_out = gn32(c)
        self.conv_out = nn.Conv2d(c, 3, 3, padding=1)

    def forward(self, z):
        x = self.mid(self.conv_in(z))
        for lv in reversed(self.up):
            x = lv(x)
        return self.conv_out(F.silu(self.norm_out(x)))


class Autoencoder(nn.Module):
    def __init__(self, ch=128, mults=(1, 2, 4, 4), zc=4):
        super().__init__()
        self.encoder = Encoder(ch, mults, 2, zc)
        self.decoder = Decoder(ch, mults, 2, zc)
        self.quant_conv = nn.Conv2d(2 * zc, 2 * zc, 1)
        self.post_quant_conv = nn.Conv2d(zc, zc, 1)

    def moments(self, img):
        """img [B,H,W,3] -> posterior (mean, std), NHWC."""
        m = self.quant_conv(self.encoder(img.permute(0, 3, 1, 2)))
        mean, logvar = m.permute(0, 2, 3, 1).chunk(2, dim=-1)
        return mean, torch.exp(0.5 * logvar.clamp(-30.0, 20.0))

    def decode(self, z):
        """scaled latents [B,h,w,4] -> images [B,H,W,3]."""
        x = self.post_quant_conv((z / SCALE).permute(0, 3, 1, 2))
        return self.decoder(x).permute(0, 2, 3, 1)


class Stack(nn.Module):
    """The UNet and the VAE under the names the runner gives them."""

    def __init__(self, cfg: dict):
        super().__init__()
        u, a = cfg["unet"], cfg["autoencoder"]
        self.unet = UNet(u["channels"], u["channel_multipliers"],
                         u["attention_levels"], u["n_res_blocks"],
                         u["n_heads"], u["d_cond"], u["in_channels"])
        self.ae = Autoencoder(a["channels"], a["ch_mults"], a["z_channels"])


def alpha_bar(cfg: dict, device) -> torch.Tensor:
    s = cfg["schedule"]
    beta = torch.linspace(s["linear_start"] ** 0.5, s["linear_end"] ** 0.5,
                          s["n_steps"], dtype=torch.float32,
                          device=device) ** 2
    return torch.cumprod(1.0 - beta, dim=0)


def hash_context(prompts, d_cond: int, length: int = 77) -> np.ndarray:
    """The prompt-hash context: a standard normal [length, d_cond] from the
    first four bytes of the prompt's SHA-256."""
    out = []
    for p in prompts:
        seed = int.from_bytes(hashlib.sha256(p.encode("utf-8")).digest()[:4],
                              "little")
        out.append(np.random.RandomState(seed).randn(length, d_cond)
                   .astype(np.float32))
    return np.stack(out)


@torch.no_grad()
def sample_dpmpp(unet, x, cond, uncond, scale: float, abar: torch.Tensor,
                 steps: int) -> torch.Tensor:
    t_all = abar.shape[0]
    c = t_all // steps
    taus = np.minimum(np.asarray(list(range(0, t_all, c))[:steps]) + 1,
                      t_all - 1)[::-1]
    ab = abar.cpu().numpy().astype(np.float64)
    a_c, a_n = ab[taus], np.concatenate([ab[taus[1:]], np.ones(1)])
    al_c, si_c = np.sqrt(a_c), np.sqrt(1 - a_c)
    al_n, si_n = np.sqrt(a_n), np.sqrt(1 - a_n)
    with np.errstate(divide="ignore"):
        h = np.log(al_n / si_n) - np.log(al_c / si_c)
    i2r = np.zeros_like(h)
    with np.errstate(divide="ignore", invalid="ignore"):
        i2r[1:] = h[1:] / (2 * h[:-1])
    i2r[~np.isfinite(i2r)] = 0.0
    terms = [np.float32(v) for v in (al_c, si_c, al_n,
                                      si_n / np.maximum(si_c, 1e-20),
                                      (al_c * si_n) / (si_c * al_n) - 1, i2r)]
    b = x.shape[0]
    x0_prev = torch.zeros_like(x)
    for k, tau in enumerate(taus):
        ac, sc, an, rt, em1, ir = (float(v[k]) for v in terms)
        t = torch.full((2 * b,), int(tau), dtype=torch.long, device=x.device)
        e = unet(torch.cat([x, x]), t, torch.cat([uncond, cond]))
        e_u, e_c = e.chunk(2)
        eps = e_u + scale * (e_c - e_u)
        x0 = (x - sc * eps) / ac
        d = (1 + ir) * x0 - ir * x0_prev
        x = rt * x - (an * em1) * d
        x0_prev = x0
    return x


def eps_loss(unet, z0, cond, uncond, abar, t, eps, drop) -> torch.Tensor:
    a = abar[t][:, None, None, None]
    zt = a.sqrt() * z0 + (1 - a).sqrt() * eps
    cond = torch.where(drop[:, None, None], uncond, cond)
    return torch.mean((eps - unet(zt, t, cond)) ** 2)
