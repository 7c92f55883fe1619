"""Generation sweep — the ``gen_samples`` equivalent (new_scripy.py:945-1108)
— and main-family image editing (``edit_samples``: img2img / inpaint),
counterpart of ``diffusionmodel_tpu/sample.py``.

Loads a checkpoint of either package (the EMA shadow when it has one),
runs the configured sampler per guidance scale, saves the grid
(``samples_g{w}.png``) and per-class files (``{class}_s{i}_g{w}.png``),
optionally scores the samples against real images drawn from the dataset
(``metrics.ImageMetrics`` on the run's device unless ``metrics_impl`` is
given), and dumps ``quality_metrics.json``.

Noise comes from a ``torch.Generator`` seeded with ``seed`` (Philox), so
images differ from the JAX package's (threefry) for the same seed; pass
``x_init`` (``gen_samples``) or ``noise`` (``edit_samples``) to pin it.
Both build the model from ``cfg.model`` (so ``model.dtype``,
``model.fused_upsample`` and ``model.use_pallas`` apply), read a
checkpoint of either package (a ``.pt`` through ``cfg.model``'s arch) and
run under ``device_check.fp32_compute``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from diffusionmodel_tpu_torch.checkpoint import extract_params, load_checkpoint
from diffusionmodel_tpu_torch.compat.flax_bridge import load_flax
from diffusionmodel_tpu_torch.config import Config
from diffusionmodel_tpu_torch.data import CrackDataset
from diffusionmodel_tpu_torch.device_check import fp32_compute, resolve_device
from diffusionmodel_tpu_torch.diffusion import Schedule, sample_cfg_edit
from diffusionmodel_tpu_torch.metrics import ImageMetrics
from diffusionmodel_tpu_torch.nn import build_model
from diffusionmodel_tpu_torch.trainer import _sanitize, make_sampler
from diffusionmodel_tpu_torch.utils.grid import save_image, save_samples


def _load_model(cfg: Config, ckpt_path: str, dev: torch.device):
    """The model of ``cfg.model`` with the checkpoint's sampling weights
    (the EMA shadow when it has one), and the main family's schedule."""
    mc, dc = cfg.model, cfg.diffusion
    ckpt = load_checkpoint(ckpt_path, arch=mc.arch, norm=mc.norm)
    batch_stats = ckpt.get("batch_stats", {}) if isinstance(ckpt, dict) else {}
    model = build_model(mc, dc.high_thresh, device=dev)
    load_flax(model, extract_params(ckpt), batch_stats)
    return model, Schedule.create(dc.beta1, dc.beta2, dc.n_T, dev)


def gen_samples(cfg: Config, ckpt_path: str,
                n_samples_per_class: Optional[int] = None,
                guide_scales: Optional[Sequence[float]] = None,
                eval_quality: Optional[bool] = None, dataset=None,
                metrics_impl=None, seed: int = 0, verbose: bool = True,
                sweep_one_batch: Optional[bool] = None, device=None,
                x_init=None) -> Dict:
    """Generate ``n_samples_per_class`` images per class at every scale on
    ``device`` (default CUDA; raises without it unless ``device="cpu"``).

    Classes are block-ordered (class 0 x n, class 1 x n, ...), so file
    names and grid rows match the images. ``sweep_one_batch`` runs every
    scale as one batch with a per-sample guidance vector; by default it is
    on when the combined batch has at most 48 slots. ``x_init``
    [n_classes * n, H, W, C] pins the start noise of every scale.

    Returns ``{w: {"grid_path", "seconds", "images_per_min", "images"}}``
    plus ``out_dir`` and ``quality``; a scale's seconds are the shared
    pass divided by the number of scales in a one-batch sweep. Sampling
    runs fp32 with TF32 off and cuDNN autotuned
    (``device_check.fp32_compute``)."""
    dev = resolve_device(device)
    sc, mc, dc = cfg.sample, cfg.model, cfg.diffusion
    n_per = n_samples_per_class or sc.samples_per_class
    scales = list(guide_scales or sc.guide_scales)
    do_eval = sc.eval_quality if eval_quality is None else eval_quality

    if dataset is None:
        try:
            dataset = CrackDataset(cfg.data_root, img_size=mc.img_size)
        except FileNotFoundError:
            # no dataset on disk: generic class names, no quality eval
            dataset = None
            do_eval = False
    classes = (dataset.classes if dataset is not None and dataset.classes
               else [f"class_{i}" for i in range(mc.n_classes)])
    n_classes = len(classes)
    if n_classes != mc.n_classes:
        cfg = cfg.replace(model=dataclasses.replace(mc, n_classes=n_classes))
        mc = cfg.model

    if verbose:
        print(f"Loading checkpoint: {ckpt_path}")
    model, sched = _load_model(cfg, ckpt_path, dev)
    n_sample = n_per * n_classes
    # Block-ordered classes (the reference's gen_samples regenerates them
    # cyclically while its file names assume block order,
    # new_scripy.py:447-448 vs 1051-1061)
    gen_classes = torch.arange(n_classes, device=dev).repeat_interleave(n_per)
    if sweep_one_batch is None:
        sweep_one_batch = len(scales) > 1 and n_sample * len(scales) <= 48
    if x_init is not None:
        x_init = torch.as_tensor(x_init, dtype=torch.float32).to(dev)
    if sweep_one_batch:
        sampler = make_sampler(cfg, sched, n_sample * len(scales),
                               classes=gen_classes.repeat(len(scales)))
    else:
        sampler = make_sampler(cfg, sched, n_sample, classes=gen_classes)

    out_dir = os.path.join(sc.sample_dir, f"samples_{int(time.time())}")
    os.makedirs(out_dir, exist_ok=True)
    if verbose:
        print(f"Samples will be saved to: {out_dir}")

    real_images = None
    img_metrics = (metrics_impl if metrics_impl is not None
                   else ImageMetrics(device=dev))
    if do_eval and dataset is not None and len(dataset) > 0:
        needed = n_per * min(n_classes, 4)
        rng = np.random.RandomState(seed)
        order = rng.permutation(len(dataset))[:needed]
        real_images = np.stack(
            [dataset.load(int(i), augment=False)[0] for i in order])

    generator = torch.Generator(device=dev).manual_seed(seed)
    results: Dict = {}
    quality: Dict = {}
    with fp32_compute(dev):
        sweep_gen = None
        if sweep_one_batch:
            if verbose:
                print(f"Generating all scales {scales} in ONE batch "
                      f"({n_sample * len(scales)} slots, per-sample guide_w)")
            gw = torch.tensor(scales, dtype=torch.float32).repeat_interleave(
                n_sample)
            t0 = time.time()
            sweep_gen = sampler(model, generator, gw,
                                x_init=None if x_init is None
                                else x_init.repeat(len(scales), 1, 1, 1)
                                ).cpu().numpy()
            sweep_dt = time.time() - t0
        for si, w in enumerate(scales):
            if sweep_one_batch:
                x_gen = sweep_gen[si * n_sample:(si + 1) * n_sample]
                dt = sweep_dt / len(scales)
            else:
                if verbose:
                    print(f"Generating samples with guidance scale {w}")
                t0 = time.time()
                x_gen = sampler(model, generator, float(w),
                                x_init=x_init).cpu().numpy()
                dt = time.time() - t0
            grid_path = os.path.join(out_dir, f"samples_g{w}.png")
            save_samples(x_gen, grid_path, nrow=n_per, denorm=sc.denorm)
            for i in range(len(x_gen)):
                cls = classes[i // n_per]
                save_image(x_gen[i], os.path.join(
                    out_dir, f"{cls}_s{i % n_per}_g{w}.png"), denorm=sc.denorm)
            results[w] = {
                "grid_path": grid_path,
                "seconds": dt,
                "images_per_min": len(x_gen) / max(dt, 1e-9) * 60,
                "images": x_gen,
            }
            if real_images is not None:
                try:
                    m = img_metrics.evaluate_batch(real_images,
                                                   x_gen[: len(real_images)])
                    quality[w] = m
                    if verbose:
                        print("  " + ", ".join(f"{k}={v:.4f}"
                                               for k, v in m.items()))
                except Exception as e:
                    print(f"Quality assessment failed: {e}")

    if quality:
        with open(os.path.join(out_dir, "quality_metrics.json"), "w") as f:
            json.dump(_sanitize({str(k): v for k, v in quality.items()}), f,
                      indent=2)
    results["out_dir"] = out_dir
    results["quality"] = quality
    return results


def _load_edit_image(path: str, img_size: int, channels: int) -> np.ndarray:
    """Image file -> float32 [1, H, W, C] in [-1, 1] at the model's
    resolution (LANCZOS resize)."""
    from PIL import Image

    im = Image.open(path).convert("RGB" if channels == 3 else "L")
    if im.size != (img_size, img_size):
        im = im.resize((img_size, img_size), resample=Image.LANCZOS)
    arr = np.asarray(im).astype(np.float32) * (2.0 / 255.0) - 1.0
    if channels == 1:
        arr = arr[..., None]
    return arr[None]


def _load_keep_mask(path: Optional[str], img_size: int) -> np.ndarray:
    """Inpaint keep-mask [H, W]: luminance > 0.5 of ``path`` = preserve
    the source pixel (the reference's orientation, in_paint.py:80-84,
    NEAREST resize); without a file, the bottom half (its default)."""
    if path is None:
        m = np.zeros((img_size, img_size), np.float32)
        m[img_size // 2:] = 1.0
        return m
    from PIL import Image

    im = Image.open(path).convert("L")
    if im.size != (img_size, img_size):
        im = im.resize((img_size, img_size), resample=Image.NEAREST)
    return (np.asarray(im).astype(np.float32) / 255.0 > 0.5).astype(
        np.float32)


def edit_samples(cfg: Config, ckpt_path: str, img_path: str,
                 mode: str = "img2img", class_id: int = 0,
                 guide_w: float = 2.0, strength: float = 0.75,
                 n_steps: int = 50, mask_path: Optional[str] = None,
                 batch: int = 1, seed: int = 0, eta: float = 0.0,
                 out_dir: Optional[str] = None, verbose: bool = True,
                 device=None, noise=None, noise_fn=None) -> Dict:
    """Main-family img2img / inpaint (``diffusion.sample_cfg_edit``) on
    ``device`` (default CUDA; raises without it unless ``device="cpu"``):
    the reference's two LDM editing recipes (image_to_image.py:95-149,
    in_paint.py:100-166) on a trained flagship model. ``batch`` copies of
    the source image, class ``class_id``, DDIM with ``n_steps`` over the
    schedule, ``strength`` of it run; ``mask_path`` (inpaint) as
    :func:`_load_keep_mask`. ``noise`` / ``noise_fn`` pin the draws
    (else a generator seeded with ``seed``).

    Saves ``{mode}_s{i}.png`` and ``{mode}_grid.png`` (sources over edits)
    under ``out_dir`` (default ``sample.sample_dir/edit_<time>``) and
    returns ``{"paths", "grid_path", "seconds", "out_dir"}`` as the JAX
    package does, plus the edited ``images`` [batch, H, W, C]."""
    dev = resolve_device(device)
    sc, mc, dc = cfg.sample, cfg.model, cfg.diffusion
    model, sched = _load_model(cfg, ckpt_path, dev)
    x0 = np.repeat(_load_edit_image(img_path, mc.img_size, mc.in_ch),
                   batch, axis=0)
    mask = (_load_keep_mask(mask_path, mc.img_size) if mode == "inpaint"
            else None)
    classes = torch.full((batch,), int(class_id), dtype=torch.int64,
                         device=dev)
    generator = torch.Generator(device=dev).manual_seed(seed)
    if verbose:
        print(f"{mode} on {img_path} (class {class_id}, guide {guide_w}, "
              f"strength {strength}, {n_steps}-step DDIM)")
    t0 = time.time()
    with fp32_compute(dev):
        out = sample_cfg_edit(
            model, generator, x0, mc.n_classes, sched, dc, guide_w=guide_w,
            n_steps=n_steps, strength=strength, inpaint_mask=mask,
            classes=classes, eta=eta, discretize=sc.ddim_discretize,
            noise=noise, noise_fn=noise_fn).cpu().numpy()
    dt = time.time() - t0

    out_dir = out_dir or os.path.join(sc.sample_dir,
                                      f"edit_{int(time.time())}")
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i in range(len(out)):
        p = os.path.join(out_dir, f"{mode}_s{i}.png")
        save_image(out[i], p, denorm=sc.denorm)
        paths.append(p)
    grid_path = os.path.join(out_dir, f"{mode}_grid.png")
    save_samples(np.concatenate([x0, out]), grid_path, nrow=batch,
                 denorm=sc.denorm)
    if verbose:
        print(f"Wrote {len(paths)} image(s) + {grid_path} in {dt:.1f}s")
    return {"paths": paths, "grid_path": grid_path, "seconds": dt,
            "out_dir": out_dir, "images": out}
