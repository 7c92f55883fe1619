"""Denoiser networks of the port (ContextUnet v2 / v1)."""

from diffusionmodel_tpu_torch.nn.context_unet import ContextUnet  # noqa: F401
from diffusionmodel_tpu_torch.nn.factory import build_model  # noqa: F401
