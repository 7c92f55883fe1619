#!/usr/bin/env python3
"""Does cuDNN autotuning pay on the serving, latent-diffusion and metrics
paths? One card, fp32 with TF32 off.

    python3 tools/fp32_autotune_probe.py --autotune off|on

In one process (cuDNN keeps the algorithms it picked per shape for the
process, so run each setting in a process of its own), under
``device_check.fp32_compute(autotune=...)``, prints JSON lines with the
wall seconds of a first and a second call of:

- ``serve``: DDIM-50 at the serving slot batch (max_batch 8, a CFG batch
  of 16) on ``preset("full")`` (ContextUnet v2, n_feat 192, 256 px,
  ``use_pallas``), random weights from torch seed 0;
- ``txt2img``: ``LdmRunner(arch="sd")`` txt2img DDIM-50 at 512 px, batch 2;
- ``inception``: the proxy InceptionV3 trunk on 10 and on 25 images at
  299 px (batches of 8: the shapes 8, 2 and 1).

The first call includes cuDNN's search when autotuning is on. Prints the
card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _sync_s(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main() -> int:
    import subprocess

    ap = argparse.ArgumentParser()
    ap.add_argument("--autotune", choices=["off", "on"], required=True)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)

    from diffusionmodel_tpu_torch.config import preset
    from diffusionmodel_tpu_torch.device_check import fp32_compute
    from diffusionmodel_tpu_torch.diffusion import Schedule, sample_cfg_ddim
    from diffusionmodel_tpu_torch.metrics.image_metrics import (
        resize_to_299,
    )
    from diffusionmodel_tpu_torch.metrics.inception import proxy_inception
    from diffusionmodel_tpu_torch.models.latent_diffusion.pipelines import (
        Txt2Img,
    )
    from diffusionmodel_tpu_torch.models.latent_diffusion.runner import (
        LdmRunner,
    )
    from diffusionmodel_tpu_torch.nn import build_model

    dev = torch.device("cuda")
    on = args.autotune == "on"

    def emit(what, **kv):
        print(json.dumps({"probe": what, "autotune": args.autotune, **kv}),
              flush=True)

    cfg = preset("full", **{"model.use_pallas": True})
    dc = cfg.diffusion
    torch.manual_seed(0)
    model = build_model(cfg.model, dc.high_thresh, device=dev).eval()
    sched = Schedule.create(dc.beta1, dc.beta2, dc.n_T, dev)
    x0 = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (8, 256, 256, 3), np.float32)).to(dev)

    def serve():
        sample_cfg_ddim(model, None, 8, (256, 256, 3), 5, sched, dc,
                        guide_w=torch.full((8,), 2.0, device=dev),
                        classes=torch.arange(8, device=dev) % 5,
                        n_steps=50, x_init=x0)

    with fp32_compute(dev, autotune=on), torch.no_grad():
        emit("serve", first_s=_sync_s(serve), second_s=_sync_s(serve))
    del model
    torch.cuda.empty_cache()

    runner = LdmRunner(arch="sd", device=dev, verbose=False)
    # the runner's pipeline without its own fp32_compute block
    pipe = Txt2Img(runner.model, sampler="ddim", n_steps=50)

    def txt2img():
        pipe(runner.cond(["a road with a long crack"] * 2), batch_size=2,
             uncond=runner.cond([""] * 2),
             generator=torch.Generator(dev).manual_seed(0))

    with fp32_compute(dev, autotune=on):
        emit("txt2img", first_s=_sync_s(txt2img), second_s=_sync_s(txt2img))
    del runner
    torch.cuda.empty_cache()

    net = proxy_inception(device=dev)
    imgs = torch.rand((25, 256, 256, 3), device=dev)

    def feats(n):
        with torch.no_grad():
            for i in range(0, n, 8):
                net(resize_to_299(imgs[i:i + 8][:n - i]))

    with fp32_compute(dev, autotune=on):
        emit("inception", first_10_s=_sync_s(lambda: feats(10)),
             second_10_s=_sync_s(lambda: feats(10)),
             first_25_s=_sync_s(lambda: feats(25)),
             second_25_s=_sync_s(lambda: feats(25)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
