"""Generation sweep — the ``gen_samples`` equivalent (new_scripy.py:945-1108),
counterpart of ``diffusionmodel_tpu/sample.py``.

Loads a checkpoint of either package (the EMA shadow when it has one),
runs the configured sampler per guidance scale, saves the grid
(``samples_g{w}.png``) and per-class files (``{class}_s{i}_g{w}.png``),
optionally scores the samples against real images drawn from the dataset
(``metrics.ImageMetrics`` on the run's device unless ``metrics_impl`` is
given), and dumps ``quality_metrics.json``.

Noise comes from a ``torch.Generator`` seeded with ``seed`` (Philox), so
images differ from the JAX package's (threefry) for the same seed; pass
``x_init`` to pin the start noise. ``sample_cfg_edit`` / ``edit_samples``
(main-family img2img and inpaint) are ROADMAP A11.
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
from diffusionmodel_tpu_torch.compat.flax_bridge import state_dict_from_flax
from diffusionmodel_tpu_torch.config import Config
from diffusionmodel_tpu_torch.data import CrackDataset
from diffusionmodel_tpu_torch.device_check import fp32_compute, resolve_device
from diffusionmodel_tpu_torch.diffusion import Schedule
from diffusionmodel_tpu_torch.metrics import ImageMetrics
from diffusionmodel_tpu_torch.nn import build_model
from diffusionmodel_tpu_torch.trainer import _sanitize, make_sampler
from diffusionmodel_tpu_torch.utils.grid import save_image, save_samples


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
    ckpt = load_checkpoint(ckpt_path)
    batch_stats = ckpt.get("batch_stats", {}) if isinstance(ckpt, dict) else {}
    model = build_model(mc, dc.high_thresh, device=dev)
    model.load_state_dict(state_dict_from_flax(extract_params(ckpt),
                                               batch_stats))
    sched = Schedule.create(dc.beta1, dc.beta2, dc.n_T, dev)
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
