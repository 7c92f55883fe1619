"""Image-quality metrics of the port: FID / KID / SSIM / PSNR on the
InceptionV3 trunk (``image_metrics``, ``inception``) and the offline
folder-vs-folder evaluation of ``--mode eval`` (``folder_eval``)."""

from diffusionmodel_tpu_torch.metrics.image_metrics import (  # noqa: F401
    ImageMetrics,
    kid_from_feats,
    polynomial_mmd2,
)
