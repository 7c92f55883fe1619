"""Coordinate attention (new_scripy.py:70-140), counterpart of
``diffusionmodel_tpu/nn/coord_attn.py``.

Directional means (over W -> [B,C,H,1], over H -> [B,C,1,W]) pass through
1x1 convs + Norm + GELU, exchange information through a cross-direction
projection (a transpose plus torch-semantics adaptive average pooling,
the identity on the square maps this net produces), and give two sigmoid
attention maps mixed by sigmoid(alpha)/sigmoid(beta), normalised.

With ``use_pallas`` and GroupNorm the block runs on the packed weights
(:class:`kernels.coord_attn.CoordAttnWeights`): the CUDA kernel in eval
mode, its plain twin in train mode — the JAX package's dispatch. In eval
mode without gradients the packing is cached on the module. That path
computes in float32 inside and returns x's dtype (the kernels take
float32 or bf16 x; the packed weights stay float32).

With a bf16 ``dtype`` the plain path computes as the JAX module does:
the directional means in float32 rounded to bf16, the 1x1 convs, norms
and GELU in bf16, then the cross mix, the weighting and the product with
x promoted to float32 by the float32 scalars (gamma, alpha, beta): the
block returns float32, which the next layer rounds.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from diffusionmodel_tpu_torch.kernels.coord_attn import (
    CoordAttnWeights,
    coord_attn,
    coord_attn_plain,
)
from diffusionmodel_tpu_torch.nn.blocks import (
    Conv2d,
    gelu,
    sigmoid,
    gn_groups,
    norm_layer,
    to_nhwc,
)
from diffusionmodel_tpu_torch.ops.pool import adaptive_avg_pool_axis


class CoordAttn(nn.Module):
    def __init__(self, channels: int, reduction: int = 16,
                 norm: str = "group", use_pallas: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        red = max(1, channels // reduction)
        self.norm = norm
        self.use_pallas = use_pallas
        self.conv1_h = Conv2d(channels, red, 1, compute_dtype=dtype)
        self.conv1_w = Conv2d(channels, red, 1, compute_dtype=dtype)
        self.bn1_h = norm_layer(norm, red, dtype=dtype)
        self.bn1_w = norm_layer(norm, red, dtype=dtype)
        self.h2w_proj = Conv2d(red, red, 1, compute_dtype=dtype)
        self.w2h_proj = Conv2d(red, red, 1, compute_dtype=dtype)
        self.conv_h = Conv2d(red, channels, 1, compute_dtype=dtype)
        self.conv_w = Conv2d(red, channels, 1, compute_dtype=dtype)
        self.gamma_h = nn.Parameter(torch.zeros(1))
        self.gamma_w = nn.Parameter(torch.zeros(1))
        self.alpha = nn.Parameter(torch.zeros(1))
        self.beta = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        if self.use_pallas and self.norm == "group":
            return self._fused_path(x)
        _, _, h, w = x.shape
        dt = self.conv1_h.compute_dtype
        # [B, C, H, 1] and [B, C, 1, W], means in float32
        x_h = x.mean(dim=3, keepdim=True, dtype=torch.float32).to(dt)
        x_w = x.mean(dim=2, keepdim=True, dtype=torch.float32).to(dt)
        x_h = gelu(self.bn1_h(self.conv1_h(x_h)))
        x_w = gelu(self.bn1_w(self.conv1_w(x_w)))

        h2w = self.h2w_proj(x_h)  # [B, R, H, 1]
        w2h = self.w2h_proj(x_w)  # [B, R, 1, W]
        # permute(0,1,3,2) swaps the spatial axes, then
        # adaptive_avg_pool2d realigns length H -> W (and W -> H).
        h2w_adapted = adaptive_avg_pool_axis(h2w.transpose(2, 3), w, axis=3)
        w2h_adapted = adaptive_avg_pool_axis(w2h.transpose(2, 3), h, axis=2)
        x_h = x_h + torch.sigmoid(self.gamma_h) * w2h_adapted
        x_w = x_w + torch.sigmoid(self.gamma_w) * h2w_adapted

        a_h = sigmoid(self.conv_h(x_h))
        a_w = sigmoid(self.conv_w(x_w))
        alpha = torch.sigmoid(self.alpha)
        beta = torch.sigmoid(self.beta)
        s = alpha + beta + 1e-8
        return x * ((alpha / s) * a_h + (beta / s) * a_w)

    def _packed(self) -> CoordAttnWeights:
        """The packed weights. In eval mode without gradients they are kept
        in a plain attribute (not a buffer: ``state_dict`` is unchanged) and
        packed again only when a parameter or buffer has moved or changed
        (its ``data_ptr`` or ``_version``: ``load_state_dict``, ``.to()``,
        an in-place update). In training, or with gradients on, every call
        packs anew, so that gradients reach the parameters."""
        if self.training or torch.is_grad_enabled():
            return CoordAttnWeights.from_module(self, "group")
        key = tuple((t.data_ptr(), t._version)
                    for t in (*self.parameters(), *self.buffers()))
        cached = self.__dict__.get("_packed_cache")
        if cached is None or cached[0] != key:
            cached = (key, CoordAttnWeights.from_module(self, "group"))
            self._packed_cache = cached
        return cached[1]

    def _fused_path(self, x):
        wts = self._packed()
        g = gn_groups(self.conv1_h.out_channels, 8)
        fn = coord_attn_plain if self.training else coord_attn
        return fn(to_nhwc(x), wts, "group", g).permute(0, 3, 1, 2)
