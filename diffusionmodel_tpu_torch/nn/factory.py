"""Model factory: build the denoiser named by ModelConfig.arch
(counterpart of ``diffusionmodel_tpu/nn/factory.py``)."""

from __future__ import annotations

from typing import Optional, Union

import torch

from diffusionmodel_tpu_torch.config import ModelConfig
from diffusionmodel_tpu_torch.device_check import resolve_device
from diffusionmodel_tpu_torch.nn.blocks import compute_dtype
from diffusionmodel_tpu_torch.nn.cbam_unet import CbamContextUnet
from diffusionmodel_tpu_torch.nn.context_unet import ContextUnet
from diffusionmodel_tpu_torch.nn.mnist_unet import MnistContextUnet


def build_model(mc: ModelConfig, high_thresh: float = 1.2,
                spatial_shards: int = 0,
                device: Optional[Union[str, torch.device]] = None
                ) -> torch.nn.Module:
    """The denoiser of ``mc.arch`` in eval mode on ``device`` (default
    CUDA; raises when CUDA is missing unless ``device="cpu"``):
    ContextUnet v2 / v1, ``mnist_unet``, ``cbam_unet`` or ``ddpm_unet``
    (the labml U-Net behind the denoiser interface, float32 only, as in
    the JAX package). Parameters get PyTorch's default initialisation from
    the global torch seed and stay float32; ``model.dtype`` sets the
    compute type ("bfloat16", else float32, as the JAX factory maps it).
    Every network takes and returns [B,H,W,C]."""
    dev = resolve_device(device)
    if mc.arch not in ("context_unet_v2", "context_unet_v1", "mnist_unet",
                       "cbam_unet", "ddpm_unet"):
        raise ValueError(f"unknown arch {mc.arch!r}")
    if spatial_shards > 0:
        raise NotImplementedError(
            "spatial sharding is not ported yet: ROADMAP A12 (parallel)")
    dtype = compute_dtype(mc.dtype)
    with torch.device(dev):
        if mc.arch == "mnist_unet":
            model = MnistContextUnet(
                in_ch=mc.in_ch, n_feat=mc.n_feat, n_classes=mc.n_classes,
                img_size=mc.img_size, norm=mc.norm,
                mnist_style_ctx_flip=mc.mnist_style_ctx_flip, dtype=dtype)
        elif mc.arch == "cbam_unet":
            model = CbamContextUnet(
                in_ch=mc.in_ch, n_feat=mc.n_feat, n_classes=mc.n_classes,
                img_size=mc.img_size, norm=mc.norm, high_thresh=high_thresh,
                dtype=dtype)
        elif mc.arch == "ddpm_unet":
            from diffusionmodel_tpu_torch.models.annotated_ddpm.unet import (
                DdpmUNetAdapter,
            )

            model = DdpmUNetAdapter(
                image_channels=mc.in_ch, n_channels=mc.n_feat,
                ch_mults=tuple(mc.ch_mults), is_attn=tuple(mc.is_attn),
                n_blocks=mc.n_blocks, dropout=mc.dropout)
        else:
            model = _context_unet(mc, high_thresh, dtype)
    return model.to(memory_format=torch.channels_last).eval()


def _context_unet(mc: ModelConfig, high_thresh: float, dtype) -> ContextUnet:
    return ContextUnet(
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
        dtype=dtype,
        fused_upsample=mc.fused_upsample,
    )
