"""Image files and seeding for the LDM pipelines (counterpart of
``diffusionmodel_tpu/models/latent_diffusion/util.py``). PIL is imported
only inside the functions that read or write image files."""

from __future__ import annotations

import os
import random
from typing import Optional, Tuple, Union

import numpy as np
import torch

from diffusionmodel_tpu_torch.device_check import resolve_device


def load_img(path: str, size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """An image file -> float32 [1, H, W, 3] in [-1, 1]: RGB, both sides cut
    down to multiples of 32 (``size=(h, w)`` forces a target first),
    LANCZOS resampling."""
    from PIL import Image

    image = Image.open(path).convert("RGB")
    w, h = image.size
    if size is not None:
        h, w = size
    w -= w % 32
    h -= h % 32
    if (w, h) != image.size:
        image = image.resize((w, h), resample=Image.LANCZOS)
    arr = np.asarray(image).astype(np.float32) * (2.0 / 255.0) - 1.0
    return arr[None]


def save_images(images, dest_path: str, prefix: str = "",
                img_format: str = "jpeg") -> list:
    """Save [B, H, W, C] images in [-1, 1] as ``{prefix}{i:05}.{format}``
    under ``dest_path``. Returns the paths."""
    from PIL import Image

    os.makedirs(dest_path, exist_ok=True)
    images = np.clip((np.asarray(images, np.float32) + 1.0) / 2.0, 0.0, 1.0)
    paths = []
    for i, img in enumerate(images):
        out = os.path.join(dest_path, f"{prefix}{i:05}.{img_format}")
        Image.fromarray((255.0 * img).astype(np.uint8)).save(
            out, format=img_format)
        paths.append(out)
    return paths


def set_seed(seed: int, device: Optional[Union[str, torch.device]] = None
             ) -> torch.Generator:
    """Seed Python's and numpy's generators and return a
    ``torch.Generator`` on ``device`` (``None``: the GPU, which must be
    present) seeded with ``seed``, which the pipelines draw from (the JAX
    package returns a PRNG key here)."""
    dev = resolve_device(device)
    random.seed(seed)
    np.random.seed(seed)
    return torch.Generator(device=dev).manual_seed(seed)
