"""CLI of the port (counterpart of ``diffusionmodel_tpu/cli.py``).

    python -m diffusionmodel_tpu_torch.cli --mode serve --ckpt PATH \
        [--port 8000] [--max_batch 8] [--sampler ddim] [--steps 50]
    python -m diffusionmodel_tpu_torch.cli --mode txt2img --prompt TEXT \
        [--ldm_arch sd] [--ldm_sampler ddim] [--steps 50] [--batch_size 1]
    python -m diffusionmodel_tpu_torch.cli --mode img2img|inpaint \
        --orig_img FILE [--strength 0.75]
    python -m diffusionmodel_tpu_torch.cli --mode train_ldm --data_root DIR \
        [--img_size 256] [--epochs 10] [--batch_size 4] [--remat] \
        [--train_ae_epochs 0] [--ldm_native OUT.pkl]

``--mode serve``, the latent-diffusion modes txt2img / img2img / inpaint
and their training, ``train_ldm``, are ported; the other modes of the JAX
CLI (and ``--family main`` editing) print that they are not ported yet and
return 1. Flags keep the JAX CLI's spellings and defaults; ``--device``
(default cuda) is the port's own.
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
                   help="serve (HTTP generation service), the "
                        "latent-diffusion pipelines txt2img / img2img / "
                        "inpaint and train_ldm are ported; the other modes "
                        "are not yet")
    p.add_argument("--ckpt", "--checkpoint", dest="ckpt", type=str,
                   default=None, help="serve: a JAX package checkpoint "
                   "(.pkl or a directory with payload.pkl); LDM modes: an "
                   "SD-v1 .ckpt")
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
    p.add_argument("--seed", type=int, default=None)
    # LDM modes (txt2img / img2img / inpaint)
    p.add_argument("--prompt", type=str,
                   default="a painting of a virus monster playing guitar",
                   help="LDM modes: the text prompt")
    p.add_argument("--orig_img", "--orig-img", dest="orig_img", type=str,
                   default=None, help="img2img/inpaint: input image file")
    p.add_argument("--batch_size", type=int, default=1,
                   help="LDM modes: images per prompt; train_ldm: the "
                        "training batch")
    p.add_argument("--scale", type=float, default=None,
                   help="LDM unconditional guidance scale (default 7.5 "
                        "txt2img / 5.0 img2img+inpaint)")
    p.add_argument("--strength", type=float, default=0.75,
                   help="img2img/inpaint: noising strength")
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--flash", dest="flash", action="store_true",
                   default=True, help="self-attention through the CUDA "
                   "flash-attention kernel at N >= 2048 (default on)")
    p.add_argument("--no_flash", dest="flash", action="store_false")
    p.add_argument("--ldm_arch", type=str, default="sd",
                   choices=["sd", "tiny", "mid"],
                   help="sd = SD-v1 scale (860M); tiny = smoke-test size; "
                        "mid = ~1/10 of sd")
    p.add_argument("--family", type=str, default="ldm",
                   choices=["ldm", "main"],
                   help="img2img/inpaint: ldm (ported) or main (the "
                        "flagship's editing, not ported yet)")
    p.add_argument("--ldm_sampler", type=str, default="ddim",
                   choices=["ddim", "ddpm", "dpmpp"],
                   help="txt2img sampler (img2img/inpaint use DDIM)")
    p.add_argument("--ldm_native", type=str, default=None,
                   help="LDM modes: load a --mode train_ldm checkpoint "
                        "({arch, unet, ae} pickle, from either package); "
                        "train_ldm: where to write it (default "
                        "OUT_DIR/ldm_native.pkl)")
    p.add_argument("--out_dir", type=str, default="./output/ldm/")
    # train_ldm
    p.add_argument("--img_size", type=int, default=256,
                   help="train_ldm: image size (a multiple of 8)")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-4,
                   help="train_ldm: Adam learning rate")
    p.add_argument("--uncond_prob", type=float, default=0.1,
                   help="train_ldm: CFG conditioning-dropout probability")
    p.add_argument("--prompt_template", type=str, default="a photo of a {}",
                   help="train_ldm: per-image prompt from its class "
                        "subdirectory name ('{}' slot); flat folders use "
                        "--prompt for every image")
    p.add_argument("--remat", action="store_true",
                   help="train_ldm: recompute the UNet forward in the "
                        "backward (torch.utils.checkpoint)")
    p.add_argument("--train_ae_epochs", type=int, default=0,
                   help="train_ldm: first train the VAE on the same images "
                        "for this many epochs (recon L1 + tiny KL)")
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


def _ldm(args) -> int:
    """--mode txt2img | img2img | inpaint (the latent-diffusion stack)."""
    from diffusionmodel_tpu_torch.models.latent_diffusion.runner import (
        LdmRunner,
    )
    from diffusionmodel_tpu_torch.models.latent_diffusion.util import (
        load_img,
        save_images,
        set_seed,
    )

    if args.mode != "txt2img" and not args.orig_img:
        print(f"Error: --orig_img required for {args.mode} mode")
        return 1
    runner = LdmRunner(sd_ckpt=args.ckpt, arch=args.ldm_arch,
                       use_flash=args.flash, sampler=args.ldm_sampler,
                       steps=args.steps or 50, native_ckpt=args.ldm_native,
                       device=args.device)
    gen = set_seed(args.seed if args.seed is not None else 42, runner.device)
    if args.mode == "txt2img":
        imgs = runner.txt2img(
            args.prompt, batch_size=args.batch_size, h=args.height,
            w=args.width, uncond_scale=7.5 if args.scale is None
            else args.scale, generator=gen)
    else:
        img = load_img(args.orig_img, size=(args.height, args.width))
        img = img.repeat(args.batch_size, axis=0)
        fn = runner.img2img if args.mode == "img2img" else runner.inpaint
        imgs = fn(img, args.prompt, strength=args.strength,
                  uncond_scale=5.0 if args.scale is None else args.scale,
                  generator=gen)
    paths = save_images(imgs, args.out_dir, prefix=f"{args.mode}_")
    print(f"Wrote {len(paths)} image(s): {paths[0]}"
          + (f" .. {paths[-1]}" if len(paths) > 1 else ""))
    return 0


def _train_ldm(args) -> int:
    """--mode train_ldm: the latent UNet (optionally the VAE first) on a
    folder of images, written as an {arch, unet, ae} pickle."""
    import json

    import numpy as np

    from diffusionmodel_tpu_torch.data.image_folder import ImageFolderDataset
    from diffusionmodel_tpu_torch.models.latent_diffusion.runner import (
        LdmRunner,
    )
    from diffusionmodel_tpu_torch.models.latent_diffusion.training import (
        fit_ae,
        fit_ldm,
    )

    if not args.data_root:
        print("Error: --data_root required for train_ldm mode")
        return 1
    size = args.img_size
    if size % 8:
        print(f"Error: --img_size must be a multiple of 8 (the SD f=8 VAE "
              f"contract), got {size}")
        return 1
    try:
        ds = ImageFolderDataset(args.data_root, img_size=size, normalize=True)
    except FileNotFoundError as e:
        print(f"Error: {e}")
        return 1
    images = np.stack([ds.load(i, augment=False)[0] for i in range(len(ds))])
    multi = len(ds.classes) > 1
    prompts = [args.prompt_template.format(ds.classes[ds.labels[i]])
               if multi else args.prompt for i in range(len(ds))]
    seed = args.seed if args.seed is not None else 0
    runner = LdmRunner(sd_ckpt=args.ckpt, arch=args.ldm_arch,
                       use_flash=args.flash, verbose=True,
                       seed=args.seed if args.seed is not None else 42,
                       device=args.device)
    out_path = args.ldm_native or os.path.join(args.out_dir,
                                               "ldm_native.pkl")
    bs = min(args.batch_size, len(ds))
    if args.train_ae_epochs:
        _, ae_hist = fit_ae(runner.ae, images, epochs=args.train_ae_epochs,
                            batch_size=bs, lr=args.lr, seed=seed)
        print(json.dumps({"stage": "train_ae", "epochs": len(ae_hist),
                          "first": ae_hist[0], "last": ae_hist[-1]}))
    _, history = fit_ldm(runner, images, prompts, epochs=args.epochs,
                         batch_size=bs, lr=args.lr,
                         uncond_prob=args.uncond_prob, remat=args.remat,
                         seed=seed, out_path=out_path)
    print(json.dumps({"mode": "train_ldm", "images": len(ds),
                      "epochs": len(history),
                      "first_loss": round(history[0], 4),
                      "last_loss": round(history[-1], 4),
                      "ckpt": out_path}))
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.mode in ("txt2img", "img2img", "inpaint") \
            and not (args.family == "main" and args.mode != "txt2img"):
        return _ldm(args)
    if args.mode == "train_ldm":
        return _train_ldm(args)
    if args.mode != "serve":
        what = f"--mode {args.mode}" + (" --family main" if args.mode in (
            "img2img", "inpaint") else "")
        print(f"{what} is not ported to the PyTorch package yet; "
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
