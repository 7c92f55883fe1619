"""Denoising-trajectory GIF writer (MNIST_script.py:374-390 capability),
counterpart of ``diffusionmodel_tpu/utils/animation.py``.

The reference stores x_i frames every 20 steps plus the last 8
(MNIST_script.py:296-297) and writes a matplotlib GIF; here a sampler's
trajectory (``diffusion.sample_cfg(return_history=True)``, or the textbook
sampler's ``track_x0`` estimates) is subsampled with the same recipe and
written as an animated GIF with PIL. Tensors are taken to the host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def reference_frame_indices(n_T: int) -> np.ndarray:
    """Steps i = n_T..1 kept when i%20==0 or i==n_T or i<8, mapped to
    trajectory indices (trajectory[k] corresponds to i = n_T - k)."""
    keep = [k for k, i in enumerate(range(n_T, 0, -1))
            if i % 20 == 0 or i == n_T or i < 8]
    return np.asarray(keep)


def save_denoising_gif(history: np.ndarray, path: str, nrow: Optional[int] = None,
                       subsample: bool = True, invert: bool = False,
                       duration_ms: int = 200) -> str:
    """history: [T, N, H, W, C] sampler trajectory -> animated grid GIF."""
    from PIL import Image

    from diffusionmodel_tpu_torch.utils.grid import make_grid

    if hasattr(history, "detach"):
        history = history.detach().float().cpu().numpy()
    history = np.asarray(history, np.float32)
    if subsample:
        history = history[reference_frame_indices(history.shape[0])]
    frames = []
    for step in history:
        img = step
        if invert:
            img = -img
        lo, hi = img.min(), img.max()
        img = (img - lo) / max(hi - lo, 1e-8)
        grid = make_grid(img, nrow=nrow)
        arr = (np.clip(grid, 0, 1) * 255).astype(np.uint8)
        if arr.shape[-1] == 1:
            arr = arr[..., 0]
        frames.append(Image.fromarray(arr))
    frames[0].save(path, save_all=True, append_images=frames[1:],
                   duration=duration_ms, loop=0)
    return path
