"""Denoiser networks of the port (ContextUnet v2 / v1, the MNIST and CBAM
variants; the labml U-Net is ``models.annotated_ddpm``)."""

from diffusionmodel_tpu_torch.nn.context_unet import ContextUnet  # noqa: F401
from diffusionmodel_tpu_torch.nn.cbam_unet import CbamContextUnet  # noqa: F401
from diffusionmodel_tpu_torch.nn.factory import build_model  # noqa: F401
from diffusionmodel_tpu_torch.nn.mnist_unet import MnistContextUnet  # noqa: F401
