"""The full ContextUnet denoiser (new_scripy.py:270-356), counterpart of
``diffusionmodel_tpu/nn/context_unet.py``.

Architecture (n_feat=192, img 256):
  init ResConvBlock(res) -> [UnetDown -> CoordAttn] x4
  (192@256 -> 192@128 -> 384@64 -> 768@32 -> 1536@16)
  -> to_vec = AvgPool(pool) + GELU (16 -> 2)
  -> FiLM embeddings: cemb*h + temb at two scales (raw-scalar t/T, Q9)
  -> up0 ConvTranspose(k=pool) + GN(8) + ReLU (2 -> 16)
  -> UnetUp x4 with skips -> LocalEnhancer (spatial mask, Q3)
  -> out: cat(up5, init_x) -> conv+GN(8)+ReLU+conv -> in_ch

``pool = min(8, img_size // 16)``. The v1 variant (scripy_old.py:124-324)
is this network without the LocalEnhancer (``use_local_enhancer=False``).

Public layout is the JAX package's: ``forward`` takes x [B,H,W,C] and
returns [B,H,W,in_ch]; inside, tensors are NCHW views in channels_last
memory. Parameter names are the reference's, so
``diffusionmodel_tpu/compat/torch_convert.py::convert_context_unet_v2``
reads ``state_dict()`` directly.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffusionmodel_tpu_torch.nn.blocks import (
    EmbedFC,
    GroupNorm,
    LocalEnhancer,
    ResConvBlock,
    UnetDown,
    UnetUp,
    channels_last,
    conv,
    gelu,
    gn_groups,
)
from diffusionmodel_tpu_torch.nn.coord_attn import CoordAttn


class ContextUnet(nn.Module):
    def __init__(self, in_ch: int = 3, n_feat: int = 192, n_classes: int = 10,
                 img_size: int = 256, norm: str = "group",
                 attn_reduction: int = 16, use_coord_attn: bool = True,
                 use_se: bool = True, use_local_enhancer: bool = True,
                 high_thresh: float = 1.2, mnist_style_ctx_flip: bool = False,
                 use_pallas: bool = False):
        super().__init__()
        nf = n_feat
        d4 = img_size // 16
        pool = min(8, d4)
        if img_size % 16 or d4 % pool:
            raise ValueError("img_size must be a multiple of 16")
        self.n_classes = n_classes
        self.pool = pool
        self.mnist_style_ctx_flip = mnist_style_ctx_flip
        self.use_coord_attn = use_coord_attn

        self.init_conv = ResConvBlock(in_ch, nf, is_res=True, use_se=use_se,
                                      norm=norm, attn_reduction=attn_reduction,
                                      use_pallas=use_pallas)
        chans = [nf, 2 * nf, 4 * nf, 8 * nf]
        in_chans = [nf, nf, 2 * nf, 4 * nf]
        for i, (ci, co) in enumerate(zip(in_chans, chans)):
            self.add_module(f"down{i + 1}", UnetDown(
                ci, co, use_se=use_se, norm=norm,
                attn_reduction=attn_reduction, use_pallas=use_pallas))
            if use_coord_attn:
                self.add_module(f"ca{i + 1}", CoordAttn(
                    co, attn_reduction, norm=norm, use_pallas=use_pallas))

        self.time_emb1 = EmbedFC(1, 8 * nf)
        self.time_emb2 = EmbedFC(1, 4 * nf)
        self.ctx_emb1 = EmbedFC(n_classes, 8 * nf)
        self.ctx_emb2 = EmbedFC(n_classes, 4 * nf)

        self.up0 = nn.Sequential(
            nn.ConvTranspose2d(8 * nf, 8 * nf, pool, stride=pool),
            GroupNorm(gn_groups(8 * nf, 8), 8 * nf), nn.ReLU())
        self.up1 = UnetUp(16 * nf, 4 * nf, norm)
        self.up2 = UnetUp(8 * nf, 2 * nf, norm)
        self.up3 = UnetUp(4 * nf, nf, norm)
        self.up4 = UnetUp(2 * nf, nf, norm)
        self.local_enhance = (LocalEnhancer(nf, high_thresh)
                              if use_local_enhancer else None)
        self.out = nn.Sequential(
            conv(2 * nf, nf, 3), GroupNorm(gn_groups(nf, 8), nf), nn.ReLU(),
            conv(nf, in_ch, 3))

    def forward(self, x: torch.Tensor, c: torch.Tensor,
                t: Union[torch.Tensor, float], ctx_mask: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: [B,H,W,C] noisy image; c: [B] int labels; t: [B] or scalar
        normalized timestep t/T; ctx_mask: [B] (1 = keep context);
        attn_mask: optional [B,H,W] spatial attention mask."""
        b = x.shape[0]
        x = channels_last(x.permute(0, 3, 1, 2))
        x0 = self.init_conv(x)

        downs = []
        h = x0
        for i in range(1, 5):
            h = getattr(self, f"down{i}")(h)
            if self.use_coord_attn:
                h = getattr(self, f"ca{i}")(h)
            downs.append(h)
        down1, down2, down3, down4 = downs

        hidden = gelu(F.avg_pool2d(down4, self.pool))

        # Context one-hot, masked (v2: multiply by keep-mask; MNIST style
        # flips 0<->1 and negates the kept one-hot, MNIST_script.py:170).
        classes = torch.arange(self.n_classes, device=x.device)
        c1h = (c.to(x.device)[:, None] == classes[None, :]).to(x.dtype)
        m = ctx_mask.to(device=x.device, dtype=x.dtype)[:, None]
        if self.mnist_style_ctx_flip:
            m = -1.0 * (1.0 - m)
        cvec = c1h * m

        t = torch.as_tensor(t, dtype=x.dtype, device=x.device).reshape(-1)
        if t.shape[0] == 1 and b > 1:
            t = t.expand(b)

        cemb1 = self.ctx_emb1(cvec)[:, :, None, None]
        temb1 = self.time_emb1(t[:, None])[:, :, None, None]
        cemb2 = self.ctx_emb2(cvec)[:, :, None, None]
        temb2 = self.time_emb2(t[:, None])[:, :, None, None]

        up1 = self.up0(hidden)
        up2 = self.up1(cemb1 * up1 + temb1, down4)
        up3 = self.up2(cemb2 * up2 + temb2, down3)
        up4 = self.up3(up3, down2)
        up5 = self.up4(up4, down1)
        if self.local_enhance is not None:
            up5 = self.local_enhance(up5, attn_mask)

        out = self.out(torch.cat([up5, x0], dim=1))
        return channels_last(out).permute(0, 2, 3, 1)
