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
returns [B,H,W,in_ch] in the compute ``dtype`` (float32 or bfloat16;
parameters are float32 either way, cast where they are used, see
``nn/blocks.py``); inside, tensors are NCHW views in channels_last
memory. As in the JAX package, the one-hot, the context mask and t are
cast to ``dtype`` (t/T in bf16 rounds neighbouring steps near 1 to one
value), and ``fused_upsample`` takes the fused head in every UnetUp.
Parameter names are the reference's, so
``diffusionmodel_tpu/compat/torch_convert.py::convert_context_unet_v2``
reads ``state_dict()`` directly.

``spatial_shards`` > 0 gives the net the JAX package's spatial hooks:
once ``parallel.spatial.attach`` has given it a 'spatial' group of that
size (which must divide ``img_size``), ``forward`` takes an H-slab (or a whole map) and returns the same
layout, and between its layers applies ``constrain_spatial`` at the JAX
sites (the stem, each down stage, up0 and each up stage): H stays split
while a slab holds at least 8 rows and is gathered below that. The
layers on the slabs compute their rows of the whole map's result
(``nn/blocks.py``), so the output is the unsharded net's up to summation
order.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffusionmodel_tpu_torch.nn.blocks import (
    ConvTranspose2d,
    EmbedFC,
    LocalEnhancer,
    ResConvBlock,
    UnetDown,
    UnetUp,
    channels_last,
    conv,
    gelu,
    norm_act,
)
from diffusionmodel_tpu_torch.nn.coord_attn import CoordAttn
from diffusionmodel_tpu_torch.parallel.spatial import (
    constrain_spatial,
    is_slab,
    match_layout,
)


class ContextUnet(nn.Module):
    # the flax-tree walk of compat.flax_bridge (v1 and v2 share it)
    layout = {"arch": "context_unet_v2"}
    spatial = None  # a parallel.spatial.SpatialGroup on a sharded forward

    def __init__(self, in_ch: int = 3, n_feat: int = 192, n_classes: int = 10,
                 img_size: int = 256, norm: str = "group",
                 attn_reduction: int = 16, use_coord_attn: bool = True,
                 use_se: bool = True, use_local_enhancer: bool = True,
                 high_thresh: float = 1.2, mnist_style_ctx_flip: bool = False,
                 use_pallas: bool = False, dtype: torch.dtype = torch.float32,
                 fused_upsample: bool = False, spatial_shards: int = 0):
        super().__init__()
        dt = self.dtype = dtype
        self.spatial_shards = spatial_shards
        self.img_size = img_size
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
                                      use_pallas=use_pallas, dtype=dt)
        chans = [nf, 2 * nf, 4 * nf, 8 * nf]
        in_chans = [nf, nf, 2 * nf, 4 * nf]
        for i, (ci, co) in enumerate(zip(in_chans, chans)):
            self.add_module(f"down{i + 1}", UnetDown(
                ci, co, use_se=use_se, norm=norm,
                attn_reduction=attn_reduction, use_pallas=use_pallas,
                dtype=dt))
            if use_coord_attn:
                self.add_module(f"ca{i + 1}", CoordAttn(
                    co, attn_reduction, norm=norm, use_pallas=use_pallas,
                    dtype=dt))

        self.time_emb1 = EmbedFC(1, 8 * nf, dt)
        self.time_emb2 = EmbedFC(1, 4 * nf, dt)
        self.ctx_emb1 = EmbedFC(n_classes, 8 * nf, dt)
        self.ctx_emb2 = EmbedFC(n_classes, 4 * nf, dt)

        self.up0 = nn.Sequential(
            ConvTranspose2d(8 * nf, 8 * nf, pool, stride=pool,
                            compute_dtype=dt),
            *norm_act("group", 8 * nf, "relu", dt, use_pallas))
        up = dict(norm=norm, dtype=dt, fused_upsample=fused_upsample,
                  use_pallas=use_pallas)
        self.up1 = UnetUp(16 * nf, 4 * nf, **up)
        self.up2 = UnetUp(8 * nf, 2 * nf, **up)
        self.up3 = UnetUp(4 * nf, nf, **up)
        self.up4 = UnetUp(2 * nf, nf, **up)
        self.local_enhance = (LocalEnhancer(nf, high_thresh, dtype=dt,
                                            use_pallas=use_pallas)
                              if use_local_enhancer else None)
        self.out = nn.Sequential(
            conv(2 * nf, nf, 3, dtype=dt),
            *norm_act("group", nf, "relu", dt, use_pallas),
            conv(nf, in_ch, 3, dtype=dt))

    def forward(self, x: torch.Tensor, c: torch.Tensor,
                t: Union[torch.Tensor, float], ctx_mask: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: [B,H,W,C] noisy image; c: [B] int labels; t: [B] or scalar
        normalized timestep t/T; ctx_mask: [B] (1 = keep context);
        attn_mask: optional [B,H,W] spatial attention mask."""
        b = x.shape[0]
        sp = self.spatial
        x = channels_last(x.permute(0, 3, 1, 2))
        x_in = x
        x0 = constrain_spatial(self.init_conv(x), sp)

        downs = []
        h = x0
        for i in range(1, 5):
            h = getattr(self, f"down{i}")(h)
            if self.use_coord_attn:
                h = getattr(self, f"ca{i}")(h)
            h = constrain_spatial(h, sp)
            downs.append(h)
        down1, down2, down3, down4 = downs

        # to_vec: pooled on the slabs where its windows do not cross them
        v = down4
        if is_slab(sp, v) and v.shape[2] % self.pool:
            v = sp.gather(v)
        hidden = F.avg_pool2d(v, self.pool)
        if is_slab(sp, v):
            hidden = sp.gather(hidden)
        hidden = gelu(hidden)

        # Context one-hot, masked (v2: multiply by keep-mask; MNIST style
        # flips 0<->1 and negates the kept one-hot, MNIST_script.py:170).
        dt = self.dtype
        classes = torch.arange(self.n_classes, device=x.device)
        c1h = (c.to(x.device)[:, None] == classes[None, :]).to(dt)
        m = torch.as_tensor(ctx_mask, device=x.device).to(dt)[:, None]
        if self.mnist_style_ctx_flip:
            m = -1.0 * (1.0 - m)
        cvec = c1h * m

        t = torch.as_tensor(t, device=x.device).to(dt).reshape(-1)
        if t.shape[0] == 1 and b > 1:
            t = t.expand(b)

        cemb1 = self.ctx_emb1(cvec)[:, :, None, None]
        temb1 = self.time_emb1(t[:, None])[:, :, None, None]
        cemb2 = self.ctx_emb2(cvec)[:, :, None, None]
        temb2 = self.time_emb2(t[:, None])[:, :, None, None]

        up1 = constrain_spatial(self.up0(hidden), sp)
        up2 = constrain_spatial(self.up1(cemb1 * up1 + temb1, down4), sp)
        up3 = constrain_spatial(self.up2(cemb2 * up2 + temb2, down3), sp)
        up4 = constrain_spatial(self.up3(up3, down2), sp)
        up5 = constrain_spatial(self.up4(up4, down1), sp)
        if self.local_enhance is not None:
            if attn_mask is not None:
                attn_mask = match_layout(attn_mask, up5, sp)
            up5 = self.local_enhance(up5, attn_mask)

        out = self.out(torch.cat([up5, x0], dim=1))
        out = match_layout(out, x_in, sp)  # the layout it was given
        return channels_last(out).permute(0, 2, 3, 1)
