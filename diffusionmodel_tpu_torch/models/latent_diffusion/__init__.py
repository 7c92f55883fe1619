"""The latent-diffusion stack (counterpart of
``diffusionmodel_tpu/models/latent_diffusion``): SD-v1-style UNet and VAE,
DDIM / DPM++ / DDPM samplers, txt2img / img2img / inpaint pipelines,
``LdmRunner``, and training (``training``: ``fit_ldm``, ``fit_ae``)."""

from diffusionmodel_tpu_torch.models.latent_diffusion.autoencoder import (  # noqa: F401
    Autoencoder,
    Decoder,
    Encoder,
    GaussianDistribution,
)
from diffusionmodel_tpu_torch.models.latent_diffusion.latent_diffusion import (  # noqa: F401
    CLIPTextEmbedder,
    LatentDiffusion,
    ldm_schedule,
)
from diffusionmodel_tpu_torch.models.latent_diffusion.unet import UNetModel  # noqa: F401
