"""Image grids and PNG files (counterpart of ``diffusionmodel_tpu/utils/grid.py``:
torchvision's make_grid / save_image, used at new_scripy.py:554-561,
875-877).

PNGs are written by :func:`png_bytes`, a standard-library encoder (no
imaging package is needed), after the JAX package's uint8 conversion
(optional [-1,1] -> [0,1], clip, ``x * 255 + 0.5`` truncated), so the
pixels equal the ones the JAX package writes with PIL.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np


def png_bytes(img: np.ndarray) -> bytes:
    """Encode an [H, W, 3] or [H, W, 1] (or [H, W]) uint8 image as PNG."""
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    color = {1: 0, 3: 2}[ch]
    img = np.ascontiguousarray(img, dtype=np.uint8)
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def make_grid(images: np.ndarray, nrow: Optional[int] = None, padding: int = 2,
              pad_value: float = 0.0) -> np.ndarray:
    """Tile [N,H,W,C] float images into one [GH,GW,C] grid (row-major,
    ``nrow`` images per row — torchvision semantics)."""
    images = np.asarray(images)
    n, h, w, c = images.shape
    nrow = nrow or int(np.ceil(np.sqrt(n)))
    ncol = nrow  # torchvision's nrow = images per row
    nrows = int(np.ceil(n / ncol))
    grid = np.full(
        (padding + nrows * (h + padding), padding + ncol * (w + padding), c),
        pad_value, dtype=images.dtype,
    )
    for i in range(n):
        r, col = divmod(i, ncol)
        y = padding + r * (h + padding)
        x = padding + col * (w + padding)
        grid[y:y + h, x:x + w] = images[i]
    return grid


def to_uint8(img: np.ndarray, denorm: bool = False) -> np.ndarray:
    """[H,W,C] float image -> uint8 (optionally mapping [-1,1] -> [0,1])."""
    img = np.asarray(img, dtype=np.float32)
    if denorm:
        img = img * 0.5 + 0.5
    img = np.clip(img, 0.0, 1.0)
    return (img * 255.0 + 0.5).astype(np.uint8)


def save_image(img: np.ndarray, path: str, denorm: bool = False) -> str:
    """Save an [H,W,C] float image as PNG."""
    with open(path, "wb") as f:
        f.write(png_bytes(to_uint8(img, denorm)))
    return path


def save_samples(images: np.ndarray, path: str, nrow: Optional[int] = None,
                 denorm: bool = True) -> str:
    """Denormalize + grid + save (new_scripy.py:554-561)."""
    images = np.asarray(images, dtype=np.float32)
    if denorm:
        images = images * 0.5 + 0.5
    return save_image(make_grid(images, nrow=nrow), path, denorm=False)
