"""Plain float32 SDXL base 1.0 (Podell et al., arXiv:2307.01952; sgm's
``configs/inference/sd_xl_base.yaml`` in Stability-AI/generative-models):
the latent UNet, its conditioner, DPM-Solver++(2M) with guidance over the
(context, y) pair, and the VAE decoder.

- UNet: 320 channels, multipliers 1,2,4, two ResBlocks a level, no
  attention at level 0, SpatialTransformers of depth 2 at level 1 and 10
  at level 2 and in the middle, 64-wide heads (10 at 640 channels, 20 at
  1280), Linear in/out projections on the tokens after the GroupNorm
  (``use_linear_in_transformer``), cross-attention to a [B, 77, 2048]
  context, a GeGLU feed-forward 4x, and the vector condition y [B, 2816]
  through ``label_emb`` (Linear 2816->1280, SiLU, Linear) added to the
  time embedding: 2,567,463,684 parameters.
- Conditioner (sgm's ``GeneralConditioner``): the context and the pooled
  text vector [B, 1280], then the 256-wide sinusoidal embedding (cos
  before sin) of each of the original size (h, w), the crop's top-left
  corner and the target size (h, w), concatenated in that order into y.
  The unconditional branch zeroes the text's context and pooled vector
  and keeps the size embeddings (``force_uc_zero_embeddings=["txt"]``).
- The f=8 VAE (SD-v1's architecture), latents scaled by 0.13025.
- The sampler: eps-prediction on the legacy DDPM discretisation (the
  scaled-linear schedule, 0.00085 to 0.012, 1000 steps), which is sgm's
  own for this model (``LegacyDDPMDiscretization``), not a departure;
  DPM-Solver++(2M) on uniformly spaced steps, as the SD-v1 reference.

Departures from sgm, each the port's:

- the prompt hash stands in for the two text encoders (CLIP ViT-L/14's
  layer-11 hidden state and OpenCLIP ViT-bigG/14's penultimate one and
  pooled output): the prompt's SHA-256 seeds a ``RandomState`` that draws
  the context [77, 2048], then the pooled vector [1280];
- every GroupNorm and LayerNorm takes eps 1e-6 (the port's LDM stack);
  sgm's ResBlock GroupNorms and LayerNorms take 1e-5;
- float32 with TF32 off, where the published model runs fp16 autocast.

Written in plain ``torch`` from the SD-v1 reference's blocks: every
attention is a softmax over explicit scores, no kernels. Parameter names
are sgm's checkpoint names, so the benchmark's seeded weights fill this
module and the program's alike. As for the SD-v1 reference, its callers
hold TF32 off (``lowp.tf32_allowed(False)``: PyTorch lets cuDNN take TF32
by default); the control of this float32 configuration is the same
computation with TF32 allowed.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from bench_gpu.reference import latent_diffusion as sd
from bench_gpu.reference.latent_diffusion import (
    Down,
    ResBlock,
    TransformerBlock,
    Up,
    alpha_bar,  # noqa: F401  (SD-v1's schedule, this model's too)
    gn32,
    sample_dpmpp,
    time_embedding,
)

SIZE_EMB = 256


class SpatialTransformer(nn.Module):
    """GroupNorm, Linear in-projection on the tokens, ``depth`` blocks,
    Linear out-projection, plus the input."""

    def __init__(self, c: int, heads: int, depth: int, d_cond: int):
        super().__init__()
        self.norm = gn32(c)
        self.proj_in = nn.Linear(c, c)
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(c, heads, d_cond) for _ in range(depth)])
        self.proj_out = nn.Linear(c, c)

    def forward(self, x, cond):
        b, c, h, w = x.shape
        t = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w,
                                                                  c))
        for blk in self.transformer_blocks:
            t = blk(t, cond)
        return self.proj_out(t).reshape(b, h, w, c).permute(0, 3, 1, 2) + x


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
    """x [B,h,w,4], t [B] int, (context [B,77,d_cond], y [B,adm]) -> eps
    [B,h,w,4], built from sgm's keys (``model_channels``, ``channel_mult``,
    ``attention_resolutions``, ``transformer_depth``, ...)."""

    def __init__(self, u: Dict):
        super().__init__()
        ch0, mults = u["model_channels"], u["channel_mult"]
        n_res, d_cond = u["num_res_blocks"], u["context_dim"]
        depth, d_head = u["transformer_depth"], u["num_head_channels"]
        self.channels = ch0
        d_emb = 4 * ch0

        def attn(level: int) -> bool:
            return 2 ** level in u["attention_resolutions"]

        def st(c: int, n: int) -> SpatialTransformer:
            return SpatialTransformer(c, c // d_head, n, d_cond)

        self.time_embed = nn.Sequential(nn.Linear(ch0, d_emb), nn.SiLU(),
                                        nn.Linear(d_emb, d_emb))
        self.label_emb = nn.Sequential(nn.Sequential(
            nn.Linear(u["adm_in_channels"], d_emb), nn.SiLU(),
            nn.Linear(d_emb, d_emb)))
        self.input_blocks = nn.ModuleList(
            [Stage([nn.Conv2d(u["in_channels"], ch0, 3, padding=1)])])
        skips, ch = [ch0], ch0
        for i, m in enumerate(mults):
            for _ in range(n_res):
                layers = [ResBlock(ch, ch0 * m, d_emb)]
                ch = ch0 * m
                if attn(i):
                    layers.append(st(ch, depth[i]))
                self.input_blocks.append(Stage(layers))
                skips.append(ch)
            if i != len(mults) - 1:
                self.input_blocks.append(Stage([Down(ch)]))
                skips.append(ch)
        self.middle_block = Stage([ResBlock(ch, ch, d_emb),
                                   st(ch, u["transformer_depth_middle"]),
                                   ResBlock(ch, ch, d_emb)])
        self.output_blocks = nn.ModuleList()
        for i in reversed(range(len(mults))):
            for j in range(n_res + 1):
                out = ch0 * mults[i]
                layers = [ResBlock(ch + skips.pop(), out, d_emb)]
                ch = out
                if attn(i):
                    layers.append(st(ch, depth[i]))
                if i and j == n_res:
                    layers.append(Up(ch))
                self.output_blocks.append(Stage(layers))
        self.out = nn.Sequential(gn32(ch), nn.SiLU(),
                                 nn.Conv2d(ch, u["out_channels"], 3,
                                           padding=1))

    def forward(self, x, t, cond):
        context, y = cond
        emb = self.time_embed(time_embedding(t, self.channels)) \
            + self.label_emb(y)
        x = x.permute(0, 3, 1, 2)
        hs = []
        for stage in self.input_blocks:
            x = stage(x, emb, context)
            hs.append(x)
        x = self.middle_block(x, emb, context)
        for stage in self.output_blocks:
            x = stage(torch.cat([x, hs.pop()], dim=1), emb, context)
        return self.out(x).permute(0, 2, 3, 1)


class Autoencoder(sd.Autoencoder):
    """SDXL's VAE: SD-v1's architecture; latents scaled by ``scale``."""

    def __init__(self, a: Dict, scale: float):
        super().__init__(a["channels"], a["ch_mults"], a["z_channels"])
        self.scale = scale

    def decode(self, z):
        """scaled latents [B,h,w,4] -> images [B,H,W,3]."""
        x = self.post_quant_conv((z / self.scale).permute(0, 3, 1, 2))
        return self.decoder(x).permute(0, 2, 3, 1)


class Stack(nn.Module):
    """The UNet and the VAE under the names the runner gives them."""

    def __init__(self, cfg: Dict):
        super().__init__()
        self.unet = UNet(cfg["unet"])
        self.ae = Autoencoder(cfg["autoencoder"],
                              cfg["schedule"]["scale_factor"])


def hash_text(prompts: Sequence[str], d_cond: int, d_pooled: int,
              length: int = 77) -> Tuple[np.ndarray, np.ndarray]:
    """The prompt hash's context [B, length, d_cond] and pooled vector
    [B, d_pooled]: the first four bytes of the prompt's SHA-256 seed one
    ``RandomState``, which draws the context, then the pooled vector."""
    ctx, pooled = [], []
    for p in prompts:
        seed = int.from_bytes(hashlib.sha256(p.encode("utf-8")).digest()[:4],
                              "little")
        rs = np.random.RandomState(seed)
        ctx.append(rs.randn(length, d_cond).astype(np.float32))
        pooled.append(rs.randn(d_pooled).astype(np.float32))
    return np.stack(ctx), np.stack(pooled)


def size_vector(pooled: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """y: the pooled vector, then the embeddings of the original size
    (h, w), the crop's corner (0, 0) and the target size (h, w), each
    number's embedding in turn (sgm flattens [B, 2] to [2B] and back)."""
    b = pooled.shape[0]
    nums = torch.tensor([h, w, 0, 0, h, w], dtype=torch.float32,
                        device=pooled.device).repeat(b)
    emb = time_embedding(nums, SIZE_EMB).reshape(b, 6 * SIZE_EMB)
    return torch.cat([pooled, emb], dim=1)


def conditioning(cfg: Dict, prompts: Sequence[str], h: int, w: int,
                 device) -> Tuple[Tuple, Tuple]:
    """(cond, uncond), each a (context, y) pair, of ``prompts`` at h x w."""
    u = cfg["unet"]
    d_pooled = u["adm_in_channels"] - 6 * SIZE_EMB
    ctx, pooled = hash_text(prompts, u["context_dim"], d_pooled)
    ctx = torch.from_numpy(ctx).to(device)
    pooled = torch.from_numpy(pooled).to(device)
    cond = (ctx, size_vector(pooled, h, w))
    uncond = (torch.zeros_like(ctx),
              size_vector(torch.zeros_like(pooled), h, w))
    return cond, uncond


@torch.no_grad()
def sample_dpmpp_pair(unet, x, cond: Tuple, uncond: Tuple, scale: float,
                      abar: torch.Tensor, steps: int) -> torch.Tensor:
    """The SD-v1 reference's DPM-Solver++(2M) with guidance, over (context,
    y) pairs: each step's doubled batch [uncond; cond] carries the context
    rows and the y rows in the same order."""
    y2 = torch.cat([uncond[1], cond[1]])

    def eps(xx, t, context):
        return unet(xx, t, (context, y2))

    return sample_dpmpp(eps, x, cond[0], uncond[0], scale, abar, steps)
