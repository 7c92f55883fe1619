"""The annotated-DDPM (labml) family (counterpart of
``diffusionmodel_tpu/models/annotated_ddpm``): the textbook U-Net and
the textbook schedule's process."""

from diffusionmodel_tpu_torch.models.annotated_ddpm.unet import DdpmUNet  # noqa: F401
from diffusionmodel_tpu_torch.models.annotated_ddpm.diffusion import (  # noqa: F401
    DenoiseDiffusion,
    textbook_schedule,
)
