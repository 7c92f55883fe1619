"""MNIST loading for the ``mnist`` preset (MNIST_script.py): the port's
numpy-only copy of ``diffusionmodel_tpu/data/mnist.py``.

The standard IDX files are read from a local directory
(``train-images-idx3-ubyte[.gz]`` etc., the layout every MNIST mirror
ships); nothing is downloaded. A deterministic synthetic fallback
(``synthetic=True``) gives class-dependent digit-like blobs, so the MNIST
training path runs end to end without any files. Its draws are numpy's
(``RandomState``), so both packages make the same images.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional, Tuple

import numpy as np


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)


def _find(data_dir: str, stem: str) -> Optional[str]:
    for suffix in ("", ".gz"):
        p = os.path.join(data_dir, stem + suffix)
        if os.path.exists(p):
            return p
    return None


def load_mnist(data_dir: str = "./data/MNIST/raw", train: bool = True
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (images [N,28,28,1] float32 in [0,1], labels [N] int32)."""
    prefix = "train" if train else "t10k"
    ip = _find(data_dir, f"{prefix}-images-idx3-ubyte")
    lp = _find(data_dir, f"{prefix}-labels-idx1-ubyte")
    if ip is None or lp is None:
        raise FileNotFoundError(
            f"MNIST IDX files not found under {data_dir}; download them "
            "elsewhere or use synthetic_mnist()")
    images = _read_idx(ip).astype(np.float32)[..., None] / 255.0
    labels = _read_idx(lp).astype(np.int32)
    return images, labels


def synthetic_mnist(n: int = 512, seed: int = 0
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Class-dependent blobby 28x28 images (deterministic)."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, n).astype(np.int32)
    yy, xx = np.mgrid[0:28, 0:28].astype(np.float32)
    images = np.zeros((n, 28, 28, 1), np.float32)
    for i, c in enumerate(labels):
        cx = 8 + (c % 5) * 3 + rng.randn() * 0.5
        cy = 8 + (c // 5) * 9 + rng.randn() * 0.5
        r = 3.0 + c * 0.4
        blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * r ** 2)))
        images[i, :, :, 0] = np.clip(blob + rng.rand(28, 28) * 0.05, 0, 1)
    return images, labels


class MnistDataset:
    """Duck-typed like CrackDataset for BatchLoader (no masks)."""

    img_size = 28

    def __init__(self, data_dir: str = "./data/MNIST/raw",
                 synthetic: bool = False, n_synthetic: int = 512):
        if synthetic:
            self.images, self._labels = synthetic_mnist(n_synthetic)
        else:
            self.images, self._labels = load_mnist(data_dir)
        self.classes = [str(i) for i in range(10)]

    def __len__(self):
        return len(self.images)

    @property
    def labels(self):
        return self._labels

    def load(self, idx: int, augment: bool = False):
        # MNIST is used unnormalized in [0,1] (MNIST_script.py:323)
        return self.images[idx], int(self._labels[idx]), \
            np.ones((28, 28), np.float32)
