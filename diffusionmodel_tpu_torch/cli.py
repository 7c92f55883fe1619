"""CLI of the port (counterpart of ``diffusionmodel_tpu/cli.py``).

    python -m diffusionmodel_tpu_torch.cli --mode serve --ckpt PATH \
        [--port 8000] [--max_batch 8] [--sampler ddim] [--steps 50]

Only ``--mode serve`` is ported; the other modes of the JAX CLI print that
they are not ported yet and return 1. Flags keep the JAX CLI's spellings;
``--device`` (default cuda) is the port's own.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

_MODES = ["train", "generate", "crop", "serve", "eval", "visualize",
          "txt2img", "img2img", "inpaint", "train_ldm"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="PyTorch/CUDA port of the enhanced diffusion model")
    p.add_argument("--mode", type=str, default="train", choices=_MODES,
                   help="serve (HTTP generation service) is ported; the "
                        "other modes are not yet")
    p.add_argument("--ckpt", "--checkpoint", dest="ckpt", type=str,
                   default=None, help="JAX package checkpoint (.pkl or a "
                   "directory with payload.pkl)")
    p.add_argument("--sampler", type=str, default=None,
                   choices=["ancestral", "ddim", "dpmpp"])
    p.add_argument("--steps", type=int, default=None,
                   help="DDIM (or DPM++) sampling steps")
    p.add_argument("--preset", type=str, default="full",
                   choices=["full", "old", "mnist", "custom", "labml",
                            "generation"])
    p.add_argument("--data_root", type=str, default=None,
                   help="dataset root; class names come from its images/ "
                        "subdirectories when present")
    p.add_argument("-o", "--override", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="Nested config override, e.g. -o model.use_pallas=true")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max_batch", type=int, default=8,
                   help="serve mode: fixed sampler batch (slot) size")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


def _parse_value(v: str):
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    return v


def _class_names(data_root: str):
    """Sorted class directories under ``<data_root>/images`` (the JAX
    package's CrackDataset rule), or None when there is no such folder."""
    img_root = os.path.join(data_root, "images")
    if not os.path.isdir(img_root):
        return None
    return sorted(d for d in os.listdir(img_root)
                  if os.path.isdir(os.path.join(img_root, d))) or None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.mode != "serve":
        print(f"--mode {args.mode} is not ported to the PyTorch package yet; "
              "use python -m diffusionmodel_tpu.cli (see ROADMAP.md)")
        return 1
    if args.ckpt is None:
        print("Error: Checkpoint path required for serve mode")
        return 1

    from diffusionmodel_tpu_torch.checkpoint import (
        extract_params,
        load_checkpoint,
    )
    from diffusionmodel_tpu_torch.compat.flax_bridge import (
        state_dict_from_flax,
    )
    from diffusionmodel_tpu_torch.config import preset
    from diffusionmodel_tpu_torch.device_check import resolve_device
    from diffusionmodel_tpu_torch.diffusion import Schedule
    from diffusionmodel_tpu_torch.nn import build_model
    from diffusionmodel_tpu_torch.serving import (
        SamplerService,
        make_http_server,
    )

    overrides = {}
    for item in args.override:
        k, _, v = item.partition("=")
        overrides[k] = _parse_value(v)
    cfg = preset(args.preset, **overrides)
    if args.data_root:
        cfg = cfg.replace(data_root=args.data_root)
    if args.sampler or args.steps:
        sc = cfg.sample
        if args.sampler:
            sc = dataclasses.replace(sc, sampler=args.sampler)
        if args.steps:
            if (args.sampler or sc.sampler) == "dpmpp":
                sc = dataclasses.replace(sc, dpm_steps=args.steps)
            else:
                sc = dataclasses.replace(sc, ddim_steps=args.steps)
        cfg = cfg.replace(sample=sc)

    device = resolve_device(args.device)
    mc, dc = cfg.model, cfg.diffusion
    class_names = [f"class_{i}" for i in range(mc.n_classes)]
    found = _class_names(cfg.data_root)
    if found:
        class_names = found
        if len(found) != mc.n_classes:
            cfg = cfg.replace(model=dataclasses.replace(
                mc, n_classes=len(found)))
            mc = cfg.model
    ckpt = load_checkpoint(args.ckpt)
    bs = ckpt.get("batch_stats", {}) if isinstance(ckpt, dict) else {}
    model = build_model(mc, dc.high_thresh, device=device)
    model.load_state_dict(state_dict_from_flax(extract_params(ckpt), bs))
    sched = Schedule.create(dc.beta1, dc.beta2, dc.n_T, device)
    service = SamplerService(model, cfg, sched, max_batch=args.max_batch)
    httpd = make_http_server(service, port=args.port,
                             class_names=class_names,
                             denorm=cfg.sample.denorm)
    print(f"Serving on :{args.port} (POST /generate, GET /healthz); "
          f"classes: {class_names}")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        service.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
