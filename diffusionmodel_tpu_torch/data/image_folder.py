"""Generic image-folder dataset (CelebA-style layout): the port's copy of
``diffusionmodel_tpu/data/image_folder.py``, numpy only (PIL is imported
inside ``load``). ``--mode train_ldm`` reads its images through it.

Layouts accepted:
- flat folder of images  -> single class (unconditional training);
- ``root/<class>/*.jpg`` -> class per subdirectory (sorted order), matching
  the torchvision ImageFolder convention.

Duck-typed like :class:`CrackDataset` for :class:`BatchLoader`:
``.classes``, ``.labels``, ``.img_size``, ``load(idx, augment)`` ->
(image [H,W,C] float32, label int, mask [H,W] ones).
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def _list_images(d: str) -> List[str]:
    return sorted(
        os.path.join(d, f) for f in os.listdir(d)
        if f.lower().endswith(_EXTS)
    )


class ImageFolderDataset:
    def __init__(self, root: str, img_size: int = 64, channels: int = 3,
                 normalize: bool = False, hflip_prob: float = 0.0,
                 seed: int = 0, cache_images: bool = True):
        """``normalize=False`` keeps [0,1] (labml ToTensor semantics);
        True applies the main family's (x-0.5)/0.5 -> [-1,1]."""
        self.root = root
        self.img_size = img_size
        self.channels = channels
        self.normalize = normalize
        self.hflip_prob = hflip_prob
        self._rng = np.random.RandomState(seed)
        # uint8 decode cache — see CrackDataset.cache_images (1-core host).
        self.cache_images = cache_images
        self._cache: dict = {}

        subdirs = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d))
        )
        self.files: List[str] = []
        labels: List[int] = []
        if subdirs:
            self.classes = subdirs
            for ci, d in enumerate(subdirs):
                for f in _list_images(os.path.join(root, d)):
                    self.files.append(f)
                    labels.append(ci)
        else:
            self.classes = [os.path.basename(os.path.normpath(root)) or "images"]
            self.files = _list_images(root)
            labels = [0] * len(self.files)
        if not self.files:
            raise FileNotFoundError(f"no images under {root}")
        self.labels = np.asarray(labels, np.int32)

    def __len__(self) -> int:
        return len(self.files)

    def load(self, idx: int, augment: bool = False
             ) -> Tuple[np.ndarray, int, np.ndarray]:
        u8 = self._cache.get(idx) if self.cache_images else None
        if u8 is None:
            from PIL import Image

            img = Image.open(self.files[idx])
            img = img.convert("RGB" if self.channels == 3 else "L")
            img = img.resize((self.img_size, self.img_size), Image.BILINEAR)
            u8 = np.asarray(img, np.uint8)
            if self.cache_images:
                self._cache[idx] = u8
        x = u8.astype(np.float32) / 255.0
        if x.ndim == 2:
            x = x[..., None]
        if augment and self.hflip_prob > 0 \
                and self._rng.rand() < self.hflip_prob:
            x = x[:, ::-1].copy()
        if self.normalize:
            x = (x - 0.5) / 0.5
        mask = np.ones((self.img_size, self.img_size), np.float32)
        return x, int(self.labels[idx]), mask


class SyntheticImageDataset:
    """In-memory stand-in for ImageFolderDataset (smoke tests / no-data CLI
    runs): deterministic class-dependent colored blobs in [0,1]."""

    def __init__(self, n: int = 256, img_size: int = 64, channels: int = 3,
                 n_classes: int = 1, seed: int = 0):
        rng = np.random.RandomState(seed)
        self.img_size = img_size
        self.classes = [f"class_{i}" for i in range(n_classes)]
        self.labels = rng.randint(0, n_classes, n).astype(np.int32)
        yy, xx = np.mgrid[0:img_size, 0:img_size].astype(np.float32)
        imgs = np.zeros((n, img_size, img_size, channels), np.float32)
        for i, c in enumerate(self.labels):
            cx = img_size * (0.3 + 0.4 * ((c + 1) % 3) / 2) + rng.randn()
            cy = img_size * (0.3 + 0.4 * (c % 3) / 2) + rng.randn()
            r = img_size * 0.15
            blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * r ** 2)))
            for ch in range(channels):
                w = 0.3 + 0.7 * (((c + ch) % channels) / max(channels - 1, 1))
                imgs[i, :, :, ch] = np.clip(
                    blob * w + rng.rand(img_size, img_size) * 0.05, 0, 1)
        self.images = imgs

    def __len__(self):
        return len(self.images)

    def load(self, idx: int, augment: bool = False):
        return self.images[idx], int(self.labels[idx]), \
            np.ones((self.img_size, self.img_size), np.float32)
