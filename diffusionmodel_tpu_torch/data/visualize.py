"""Dataset visualization (test_DroneDataset.py:8-94 capability).

Renders N dataset samples as a 3-panel figure each: original image with
bbox, transformed image with scaled bbox, and the attention-mask heatmap —
saved to ``dataset_visualization.png``. Pure PIL (no matplotlib, PIL
imported when a sheet is drawn), so it runs in minimal images. The port's
copy of ``diffusionmodel_tpu/data/visualize.py``.
"""

from __future__ import annotations

import numpy as np


def _heatmap(mask: np.ndarray) -> np.ndarray:
    """Simple viridis-like colormap for the attention mask."""
    lo, hi = mask.min(), mask.max()
    t = (mask - lo) / max(hi - lo, 1e-8)
    r = np.clip(1.5 * t - 0.25, 0, 1)
    g = np.clip(1.5 * t, 0, 1) * 0.8 + 0.1
    b = np.clip(1.0 - 1.2 * t, 0, 1)
    return np.stack([r, g, b], axis=-1)


def _draw_box(img: np.ndarray, box, color=(1.0, 0.0, 0.0), width=2):
    x0, y0, x1, y1 = [int(v) for v in box]
    h, w = img.shape[:2]
    x0, x1 = max(0, x0), min(w - 1, x1)
    y0, y1 = max(0, y0), min(h - 1, y1)
    img = img.copy()
    img[y0:y0 + width, x0:x1] = color
    img[max(y1 - width, 0):y1, x0:x1] = color
    img[y0:y1, x0:x0 + width] = color
    img[y0:y1, max(x1 - width, 0):x1] = color
    return img


def visualize_dataset_samples(dataset, n_samples: int = 5,
                              out_path: str = "dataset_visualization.png",
                              seed: int = 0) -> str:
    from PIL import Image

    from diffusionmodel_tpu_torch.data.crack_dataset import parse_voc_bbox

    rng = np.random.RandomState(seed)
    idxs = rng.permutation(len(dataset))[:n_samples]
    s = dataset.img_size
    rows = []
    for idx in idxs:
        img_path, xml_path, label = dataset.samples[int(idx)]
        bbox, (ow, oh) = parse_voc_bbox(xml_path)
        orig = np.asarray(
            Image.open(img_path).convert("RGB").resize((s, s)),
            np.float32) / 255.0
        panel1 = _draw_box(orig, [bbox[0] * s / ow, bbox[1] * s / oh,
                                  bbox[2] * s / ow, bbox[3] * s / oh])
        x, _, mask = dataset.load(int(idx), augment=False)
        panel2 = _draw_box(np.clip(x * 0.5 + 0.5, 0, 1) if x.min() < 0 else x,
                           [bbox[0] * s / ow, bbox[1] * s / oh,
                            bbox[2] * s / ow, bbox[3] * s / oh])
        panel3 = _heatmap(mask)
        rows.append(np.concatenate([panel1, panel2, panel3], axis=1))
    sheet = np.concatenate(rows, axis=0)
    Image.fromarray((np.clip(sheet, 0, 1) * 255).astype(np.uint8)).save(out_path)
    return out_path
