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
block returns float32, which the next layer rounds. Under
``nn.blocks.precast_params`` (the JAX package's bf16 sampler, which casts
every parameter to bf16) the scalars are bf16, and the mix, the weighting
and the product stay in bf16.

On the 'model' axis (``parallel.tensor``) ``conv_h`` and ``conv_w``
hold blocks of their output channels: the plain path runs them as
tensor-parallel layers, and the packing gathers them whole, so the
kernels and their twins take whole weights.

On an H-slab of a spatially sharded forward (``parallel.spatial``) the
W-pool is the sum of the slabs' column sums (one all_reduce) and the
H-pool is gathered whole ([B, C, H, 1], small): the bottleneck (its
norms, the cross mix, the realignment) runs replicated on every process,
and each applies its own rows of ``a_h``. The fused path does the same
through the kernels' slab form (``kernels.coord_attn.coord_attn_slab``)
in eval mode and its twin in train mode.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from diffusionmodel_tpu_torch.kernels.coord_attn import (
    CoordAttnWeights,
    coord_attn,
    coord_attn_plain,
    coord_attn_slab,
    coord_attn_slab_plain,
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
from diffusionmodel_tpu_torch.parallel.spatial import is_slab


class CoordAttn(nn.Module):
    spatial = None  # a parallel.spatial.SpatialGroup on a sharded forward
    precast = False  # the scalars in bf16 (``nn.blocks.precast_params``)

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
        sp = self.spatial if is_slab(self.spatial, x) else None
        _, _, h, w = x.shape
        dt = self.conv1_h.compute_dtype
        # [B, C, H, 1] and [B, C, 1, W], means in float32
        x_h = x.mean(dim=3, keepdim=True, dtype=torch.float32)
        if sp is None:
            x_w = x.mean(dim=2, keepdim=True, dtype=torch.float32)
        else:  # the whole map's pools, replicated
            x_h = sp.gather(x_h)
            h = x_h.shape[2]
            x_w = sp.all_reduce(x.sum(dim=2, keepdim=True,
                                      dtype=torch.float32)) / h
        x_h, x_w = x_h.to(dt), x_w.to(dt)
        x_h = gelu(self.bn1_h(self.conv1_h(x_h)))
        x_w = gelu(self.bn1_w(self.conv1_w(x_w)))

        h2w = self.h2w_proj(x_h)  # [B, R, H, 1]
        w2h = self.w2h_proj(x_w)  # [B, R, 1, W]
        # permute(0,1,3,2) swaps the spatial axes, then
        # adaptive_avg_pool2d realigns length H -> W (and W -> H).
        h2w_adapted = adaptive_avg_pool_axis(h2w.transpose(2, 3), w, axis=3)
        w2h_adapted = adaptive_avg_pool_axis(w2h.transpose(2, 3), h, axis=2)
        # float32 scalars promote the mix and the weighting to float32; the
        # JAX package's bf16 sampler casts them to bf16 (precast_params)
        gh, gw, al, be = self.gamma_h, self.gamma_w, self.alpha, self.beta
        act = torch.sigmoid
        if self.precast:
            gh, gw, al, be = (p.to(dt) for p in (gh, gw, al, be))
            act = sigmoid
        x_h = x_h + act(gh) * w2h_adapted
        x_w = x_w + act(gw) * h2w_adapted

        a_h = sigmoid(self.conv_h(x_h))
        a_w = sigmoid(self.conv_w(x_w))
        if sp is not None:  # this slab's rows
            a_h = a_h.narrow(2, sp.row0(x.shape[2]), x.shape[2])
        alpha = act(al)
        beta = act(be)
        s = alpha + beta + 1e-8
        return x * ((alpha / s) * a_h + (beta / s) * a_w)

    def _packed(self) -> CoordAttnWeights:
        """The packed weights. In eval mode without gradients they are kept
        in a plain attribute (not a buffer: ``state_dict`` is unchanged) and
        packed again only when a parameter or buffer has moved or changed
        (its ``data_ptr`` or ``_version``: ``load_state_dict``, ``.to()``,
        an in-place update). In training, or with gradients on, every call
        packs anew, so that gradients reach the parameters. On the 'model'
        axis the packing gathers ``conv_h`` / ``conv_w`` whole from their
        blocks, which are the parameters the key reads: a step's in-place
        update of a block repacks, on every process of the group alike
        (the gather is a collective)."""
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
        if is_slab(self.spatial, x):
            fn = coord_attn_slab_plain if self.training else coord_attn_slab
            out = fn(to_nhwc(x), wts, "group", g, self.spatial)
        else:
            fn = coord_attn_plain if self.training else coord_attn
            out = fn(to_nhwc(x), wts, "group", g)
        return out.permute(0, 3, 1, 2)
