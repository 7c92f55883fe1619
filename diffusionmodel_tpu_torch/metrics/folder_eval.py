"""Offline folder-vs-folder quality evaluation (CLI ``--mode eval``),
counterpart of ``diffusionmodel_tpu/metrics/folder_eval.py``.

Scores any directory of generated images against a real set after the
fact, with the metrics of ``image_metrics`` (fid / fid_proxy, KID, the
reference-formula SSIM / PSNR).

Directory layout: either flat image files, or one subdirectory per class
(the ``images/<class>/`` half of the CrackDataset layout). When BOTH sides
have class subdirectories, SSIM / PSNR pairs are class-aligned; FID / KID
always use the full pooled sets. Images are read with PIL (imported when
a folder is loaded).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from diffusionmodel_tpu_torch.metrics.image_metrics import (
    ImageMetrics,
    calc_psnr,
    calc_ssim,
    frechet_distance,
    kid_from_feats,
)

_EXTS = (".png", ".jpg", ".jpeg", ".bmp")


def _list_images(root: str) -> Dict[str, List[str]]:
    """{class_name: [paths]}; flat dirs map to {"": [paths]}."""
    subs = sorted(
        d for d in os.listdir(root)
        if os.path.isdir(os.path.join(root, d)))
    out: Dict[str, List[str]] = {}
    if subs:
        for d in subs:
            files = sorted(
                os.path.join(root, d, f)
                for f in os.listdir(os.path.join(root, d))
                if f.lower().endswith(_EXTS))
            if files:
                out[d] = files
    if not out:
        files = sorted(
            os.path.join(root, f) for f in os.listdir(root)
            if f.lower().endswith(_EXTS))
        if not files:
            raise ValueError(f"no images found under {root}")
        out[""] = files
    return out


def _load(paths: List[str], img_size: int) -> np.ndarray:
    from PIL import Image

    imgs = []
    for p in paths:
        with Image.open(p) as im:
            im = im.convert("RGB").resize((img_size, img_size),
                                          Image.BILINEAR)
            imgs.append(np.asarray(im, np.float32) / 255.0)
    return np.stack(imgs)


def evaluate_folders(real_dir: str, gen_dir: str, metrics=None,
                     img_size: int = 256,
                     max_per_side: Optional[int] = None,
                     device=None) -> Dict[str, float]:
    """FID(-proxy) / KID over the pooled sets + class-aligned SSIM / PSNR.

    ``metrics``: an ImageMetrics (one built with ``inception_weights``
    gives true FID); by default the proxy-feature instance on ``device``
    (default CUDA). Images load as [0,1] float at ``img_size``."""
    metrics = metrics or ImageMetrics(device=device)
    real_by_cls = _list_images(real_dir)
    gen_by_cls = _list_images(gen_dir)
    if max_per_side:
        real_by_cls = {c: v[:max_per_side] for c, v in real_by_cls.items()}
        gen_by_cls = {c: v[:max_per_side] for c, v in gen_by_cls.items()}

    real_all = _load([p for v in real_by_cls.values() for p in v], img_size)
    gen_all = _load([p for v in gen_by_cls.values() for p in v], img_size)

    out: Dict[str, float] = {
        "n_real": int(len(real_all)), "n_gen": int(len(gen_all)),
    }
    if len(real_all) >= 10 and len(gen_all) >= 10:
        rf = metrics.extract_features(real_all).astype(np.float64)
        gf = metrics.extract_features(gen_all).astype(np.float64)
        out[metrics.fid_key] = float(frechet_distance(
            rf.mean(0), np.cov(rf, rowvar=False),
            gf.mean(0), np.cov(gf, rowvar=False)))
        kid_key = ("kid" if metrics.fid_key == "fid" else "kid_proxy")
        mean, std = kid_from_feats(rf, gf)
        out[f"{kid_key}_x1000"] = float(mean * 1000)
        out[f"{kid_key}_x1000_std"] = float(std * 1000)

    # SSIM / PSNR pairing: class-aligned when both sides share class dirs,
    # else i-th vs i-th (the reference's arbitrary pairing, SURVEY Q6)
    pairs: List[Tuple[np.ndarray, np.ndarray]] = []
    shared = sorted(set(real_by_cls) & set(gen_by_cls))
    if shared and set(real_by_cls) != {""}:
        for c in shared:
            r = _load(real_by_cls[c], img_size)
            g = _load(gen_by_cls[c], img_size)
            m = min(len(r), len(g))
            pairs.extend(zip(r[:m], g[:m]))
    else:
        m = min(len(real_all), len(gen_all))
        pairs.extend(zip(real_all[:m], gen_all[:m]))
    if pairs:
        out["ssim"] = float(np.mean([calc_ssim(r, g) for r, g in pairs]))
        out["psnr"] = float(np.mean([calc_psnr(r, g) for r, g in pairs]))
        out["n_pairs"] = int(len(pairs))
    return out
