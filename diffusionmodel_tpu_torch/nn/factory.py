"""Model factory: build the denoiser named by ModelConfig.arch
(counterpart of ``diffusionmodel_tpu/nn/factory.py``)."""

from __future__ import annotations

from typing import Optional, Union

import torch

from diffusionmodel_tpu_torch.config import ModelConfig
from diffusionmodel_tpu_torch.device_check import resolve_device
from diffusionmodel_tpu_torch.nn.blocks import compute_dtype
from diffusionmodel_tpu_torch.nn.context_unet import ContextUnet

# What later slices bring, by ROADMAP.md queue-A item.
_NOT_PORTED = {
    "mnist_unet": "ROADMAP A10 (side families)",
    "cbam_unet": "ROADMAP A10 (side families)",
    "ddpm_unet": "ROADMAP A10 (side families)",
}


def build_model(mc: ModelConfig, high_thresh: float = 1.2,
                spatial_shards: int = 0,
                device: Optional[Union[str, torch.device]] = None
                ) -> ContextUnet:
    """The ContextUnet v2 / v1 in eval mode on ``device`` (default CUDA;
    raises when CUDA is missing unless ``device="cpu"``). Parameters get
    PyTorch's default initialisation from the global torch seed and stay
    float32; ``model.dtype`` sets the compute type ("bfloat16", else
    float32, as the JAX factory maps it)."""
    dev = resolve_device(device)
    if mc.arch in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {mc.arch!r} is not ported yet: {_NOT_PORTED[mc.arch]}")
    if mc.arch not in ("context_unet_v2", "context_unet_v1"):
        raise ValueError(f"unknown arch {mc.arch!r}")
    if spatial_shards > 0:
        raise NotImplementedError(
            "spatial sharding is not ported yet: ROADMAP A12 (parallel)")
    with torch.device(dev):
        model = ContextUnet(
            in_ch=mc.in_ch,
            n_feat=mc.n_feat,
            n_classes=mc.n_classes,
            img_size=mc.img_size,
            norm=mc.norm,
            attn_reduction=mc.attn_reduction,
            use_coord_attn=mc.use_coord_attn,
            use_se=mc.use_se,
            use_local_enhancer=mc.use_local_enhancer
            and mc.arch == "context_unet_v2",
            high_thresh=high_thresh,
            mnist_style_ctx_flip=mc.mnist_style_ctx_flip,
            use_pallas=mc.use_pallas,
            dtype=compute_dtype(mc.dtype),
            fused_upsample=mc.fused_upsample,
        )
    return model.to(memory_format=torch.channels_last).eval()
