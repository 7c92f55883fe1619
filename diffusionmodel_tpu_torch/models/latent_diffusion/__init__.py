"""The latent-diffusion stack (counterpart of
``diffusionmodel_tpu/models/latent_diffusion``): SD-v1-style UNet and VAE,
DDIM / DPM++ / DDPM samplers, txt2img / img2img / inpaint pipelines and
``LdmRunner``. Inference only: LDM training is not ported yet."""

from diffusionmodel_tpu_torch.models.latent_diffusion.autoencoder import (  # noqa: F401
    Autoencoder,
    Decoder,
    Encoder,
    GaussianDistribution,
)
from diffusionmodel_tpu_torch.models.latent_diffusion.latent_diffusion import (  # noqa: F401
    LatentDiffusion,
    ldm_schedule,
)
from diffusionmodel_tpu_torch.models.latent_diffusion.unet import UNetModel  # noqa: F401
