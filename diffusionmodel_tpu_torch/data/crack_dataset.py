"""Crack image dataset: directory-per-class images + Pascal-VOC XML bboxes
-> (image, label, attention-mask) triples (new_scripy.py:479-551). The
port's numpy-only copy of ``diffusionmodel_tpu/data/crack_dataset.py``;
PIL is imported only where an image file is decoded.

Layout (produced by the crop tool / expected by the reference):

    root/images/<class_name>/*.{png,jpg,jpeg}
    root/annotations/<image_stem>.xml

The attention mask (new_scripy.py:535-546): base 0.5 everywhere, 1.0 on the
lower half, 3.0 inside the bbox rescaled from original image coords to
img_size with round + clamp to [0, img_size-1].

Parity notes:
- classes are the sorted directory names (new_scripy.py:496-498);
- an image without a matching XML is skipped (new_scripy.py:505-511);
- transforms: PIL bilinear resize to (S, S), optional horizontal flip with
  p=0.5 applied to the image ONLY (Q5 — the reference does not co-flip the
  mask; ``co_flip_mask=True`` opts into the fix, and the trainer turns it on
  by default through ``train.co_flip_mask``), scale to [0,1], normalize
  (x-0.5)/0.5 (new_scripy.py:683-688);
- stratified 90/10 split via sklearn StratifiedShuffleSplit(random_state=42)
  (new_scripy.py:622-657) when sklearn is importable, else a deterministic
  numpy split that keeps per-class proportions (the JAX package's same
  fallback, so the two packages split alike wherever they run).

``CrackDataset.from_arrays`` builds the same dataset from images and boxes
already in memory (no files, no imaging package).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import List, Sequence, Tuple

import numpy as np

IMG_EXTS = (".png", ".jpg", ".jpeg")


def build_attn_mask(img_size: int, bbox: Tuple[int, int, int, int],
                    orig_wh: Tuple[int, int], low: float = 0.5,
                    mid: float = 1.0, high: float = 3.0) -> np.ndarray:
    """The spatial loss/attention mask (new_scripy.py:535-546)."""
    xmin, ymin, xmax, ymax = bbox
    ow, oh = orig_wh
    mask = np.full((img_size, img_size), low, dtype=np.float32)
    mask[img_size // 2:, :] = mid

    def sx(v):
        return max(0, min(img_size - 1, round(v * img_size / ow)))

    def sy(v):
        return max(0, min(img_size - 1, round(v * img_size / oh)))

    mask[sy(ymin):sy(ymax), sx(xmin):sx(xmax)] = high
    return mask


def parse_voc_bbox(xml_path: str) -> Tuple[Tuple[int, int, int, int],
                                           Tuple[int, int]]:
    """First bndbox + (width, height) from a Pascal-VOC XML."""
    root = ET.parse(xml_path).getroot()
    bb = root.find(".//bndbox")
    bbox = tuple(int(float(bb.find(k).text))
                 for k in ("xmin", "ymin", "xmax", "ymax"))
    ow = int(float(root.find(".//width").text))
    oh = int(float(root.find(".//height").text))
    return bbox, (ow, oh)


class CrackDataset:
    def __init__(self, root_dir: str, img_size: int = 256,
                 mask_values: Tuple[float, float, float] = (0.5, 1.0, 3.0),
                 hflip_prob: float = 0.0, co_flip_mask: bool = False,
                 normalize: bool = True, seed: int = 0,
                 cache_images: bool = True):
        self._set_options(root_dir, img_size, mask_values, hflip_prob,
                          co_flip_mask, normalize, seed, cache_images)

        img_root = os.path.join(root_dir, "images")
        self.classes = sorted(
            d for d in os.listdir(img_root)
            if os.path.isdir(os.path.join(img_root, d))
        )
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}

        self.samples: List[Tuple[str, str, int]] = []
        for cls in self.classes:
            cdir = os.path.join(img_root, cls)
            for name in sorted(os.listdir(cdir)):
                if not name.lower().endswith(IMG_EXTS):
                    continue
                stem = name.rsplit(".", 1)[0]
                xml_path = os.path.join(root_dir, "annotations", stem + ".xml")
                if os.path.exists(xml_path):
                    self.samples.append(
                        (os.path.join(cdir, name), xml_path,
                         self.class_to_idx[cls]))

    def _set_options(self, root_dir, img_size, mask_values, hflip_prob,
                     co_flip_mask, normalize, seed, cache_images):
        self.root_dir = root_dir
        self.img_size = img_size
        self.mask_values = mask_values
        self.hflip_prob = hflip_prob
        self.co_flip_mask = co_flip_mask
        self.normalize = normalize
        self._rng = np.random.RandomState(seed)
        # decode + resize once; keep uint8 [S,S,3] + the parsed bbox
        self.cache_images = cache_images
        self._cache: dict = {}

    @classmethod
    def from_arrays(cls, images: np.ndarray,
                    bboxes: Sequence[Tuple[int, int, int, int]],
                    labels: Sequence[int], classes: Sequence[str],
                    orig_wh: Tuple[int, int] = (512, 512),
                    mask_values: Tuple[float, float, float] = (0.5, 1.0, 3.0),
                    hflip_prob: float = 0.0, co_flip_mask: bool = False,
                    normalize: bool = True, seed: int = 0) -> "CrackDataset":
        """A dataset of images held in memory: uint8 ``images`` [N,S,S,3]
        (already at ``img_size`` S), one box per image in the original
        ``orig_wh`` coordinates, and class indices into ``classes``.
        ``load`` / ``load_wire`` and the masks are those of a dataset read
        from files."""
        images = np.asarray(images)
        if images.dtype != np.uint8 or images.ndim != 4 \
                or images.shape[1] != images.shape[2] or images.shape[3] != 3:
            raise ValueError("images must be uint8 [N, S, S, 3], got "
                             f"{images.dtype} {images.shape}")
        if not len(images) == len(bboxes) == len(labels):
            raise ValueError("one box and one label per image")
        self = cls.__new__(cls)
        self._set_options(None, images.shape[1], tuple(mask_values),
                          hflip_prob, co_flip_mask, normalize, seed, True)
        self.classes = list(classes)
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples = [("", "", int(k)) for k in labels]
        self._cache = {i: (images[i], tuple(int(v) for v in bboxes[i]),
                           tuple(orig_wh)) for i in range(len(images))}
        return self

    def __len__(self) -> int:
        return len(self.samples)

    @property
    def labels(self) -> np.ndarray:
        return np.asarray([s[2] for s in self.samples], dtype=np.int64)

    def _decoded(self, idx: int) -> tuple:
        """(uint8 image [S,S,3], bbox, original (w, h)) of sample ``idx``."""
        hit = self._cache.get(idx) if self.cache_images else None
        if hit is not None:
            return hit
        from PIL import Image

        img_path, xml_path, _ = self.samples[idx]
        img = Image.open(img_path).convert("RGB")
        img = img.resize((self.img_size, self.img_size), Image.BILINEAR)
        out = (np.asarray(img, dtype=np.uint8),) + parse_voc_bbox(xml_path)
        if self.cache_images:
            self._cache[idx] = out
        return out

    def load(self, idx: int, augment: bool = False
             ) -> Tuple[np.ndarray, int, np.ndarray]:
        """Returns (image [S,S,3] float32 in [-1,1], label, mask [S,S])."""
        label = self.samples[idx][2]
        u8, bbox, orig_wh = self._decoded(idx)
        low, mid, high = self.mask_values
        mask = build_attn_mask(self.img_size, bbox, orig_wh, low, mid, high)

        arr = u8.astype(np.float32) / 255.0
        if augment and self.hflip_prob > 0 and self._rng.rand() < self.hflip_prob:
            arr = arr[:, ::-1, :].copy()
            if self.co_flip_mask:
                mask = mask[:, ::-1].copy()
        if self.normalize:
            arr = (arr - 0.5) / 0.5
        return arr, label, mask

    def load_wire(self, idx: int, augment: bool = False
                  ) -> Tuple[np.ndarray, int, np.ndarray]:
        """Compact wire-format sample: (uint8 image [S,S,3], label, uint8
        mask CLASS INDEX [S,S] with 0=low/1=mid/2=high). The float expansion
        happens on the device (``train.decode_wire``), bit-identical to
        :meth:`load`."""
        label = self.samples[idx][2]
        u8, bbox, orig_wh = self._decoded(idx)
        mask_idx = build_attn_mask(self.img_size, bbox, orig_wh,
                                   0.0, 1.0, 2.0).astype(np.uint8)
        if augment and self.hflip_prob > 0 \
                and self._rng.rand() < self.hflip_prob:
            u8 = u8[:, ::-1, :]
            if self.co_flip_mask:
                mask_idx = mask_idx[:, ::-1]
        return u8, label, mask_idx


def stratified_split(labels: Sequence[int], val_split: float = 0.1,
                     seed: int = 42) -> Tuple[np.ndarray, np.ndarray]:
    """Stratified train/val index split: sklearn's
    StratifiedShuffleSplit(random_state=seed) when importable (the
    reference's exact seed-42 split, new_scripy.py:630-631), else a
    deterministic numpy split keeping per-class proportions."""
    labels = np.asarray(labels)
    try:
        from sklearn.model_selection import StratifiedShuffleSplit
    except ImportError:
        StratifiedShuffleSplit = None
    if StratifiedShuffleSplit is not None:
        splitter = StratifiedShuffleSplit(
            n_splits=1, test_size=val_split, random_state=seed)
        train_idx, val_idx = next(splitter.split(np.zeros(len(labels)),
                                                 labels))
        return train_idx, val_idx
    return _numpy_split(labels, val_split, seed)


def _numpy_split(labels: np.ndarray, val_split: float, seed: int):
    rng = np.random.RandomState(seed)
    train_idx, val_idx = [], []
    for cls in np.unique(labels):
        idx = np.where(labels == cls)[0]
        rng.shuffle(idx)
        n_val = max(1, int(round(len(idx) * val_split)))
        val_idx.extend(idx[:n_val])
        train_idx.extend(idx[n_val:])
    return np.asarray(sorted(train_idx)), np.asarray(sorted(val_idx))
