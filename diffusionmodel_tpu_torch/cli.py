"""CLI of the port (counterpart of ``diffusionmodel_tpu/cli.py``).

    python -m diffusionmodel_tpu_torch.cli --mode train [--preset full] \
        [--data_root DIR] [--save_dir DIR] [--epochs N] [--resume CKPT]
    python -m diffusionmodel_tpu_torch.cli --mode generate --ckpt PATH \
        [--guide_scales 2.0 4.0] [--samples 3] [--sampler dpmpp] \
        [--steps 20] [--no_eval]
    python -m diffusionmodel_tpu_torch.cli --mode serve --ckpt PATH \
        [--port 8000] [--max_batch 8] [--sampler ddim] [--steps 50]
    python -m diffusionmodel_tpu_torch.cli --mode txt2img --prompt TEXT \
        [--ldm_arch sd] [--ldm_sampler ddim] [--steps 50] [--batch_size 1]
    python -m diffusionmodel_tpu_torch.cli --mode img2img|inpaint \
        --orig_img FILE [--strength 0.75]
    python -m diffusionmodel_tpu_torch.cli --mode img2img|inpaint \
        --family main --ckpt PATH --orig_img FILE [--mask_img FILE] \
        [--class_id 0] [--scale 2.0] [--steps 50] [--strength 0.75]
    python -m diffusionmodel_tpu_torch.cli --mode train_ldm --data_root DIR \
        [--img_size 256] [--epochs 10] [--batch_size 4] [--remat] \
        [--train_ae_epochs 0] [--ldm_native OUT.pkl]
    python -m diffusionmodel_tpu_torch.cli --mode eval --real_dir DIR \
        --gen_dir DIR [--eval_out FILE] [--img_size 256] \
        [--inception_weights FILE]
    python -m diffusionmodel_tpu_torch.cli --mode visualize --data_root DIR \
        [--viz_out FILE] [--samples 5]
    python -m diffusionmodel_tpu_torch.cli --mode crop --img_dir DIR \
        --anno_dir DIR [--anno_format voc|datasetninja] [--crop_out DIR] \
        [--crop_size 512]

Every mode of the JAX CLI is ported, for every preset (``full``, ``old``,
``generation``, ``mnist``, ``custom``, ``labml``) and both editing
families; only multi-device training (mesh axes, ZeRO-1: ROADMAP A12)
prints that it is not ported and returns 1. ``--preset mnist`` trains on
the MNIST IDX files under ``--data_root`` or a synthetic set, ``labml`` on
an image folder or a synthetic one, as the JAX CLI does.
``--inception_weights`` (a torchvision inception_v3 state dict,
``.npz`` or ``.pt``) scores true FID in train, generate and eval;
without it the score is ``fid_proxy``. Flags keep the JAX CLI's
spellings and defaults; ``--device`` (default cuda) is the port's own.
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
                   help="train, generate, crop (offline dataset build), "
                        "serve (HTTP generation service), eval (offline "
                        "folder-vs-folder quality metrics), visualize "
                        "(dataset/mask inspection sheet), or the "
                        "latent-diffusion modes txt2img / img2img / "
                        "inpaint / train_ldm")
    p.add_argument("--ckpt", "--checkpoint", dest="ckpt", type=str,
                   default=None, help="generate / serve: a checkpoint of "
                   "either package (.pkl or a directory with payload.pkl); "
                   "LDM modes: an SD-v1 .ckpt")
    p.add_argument("--guide_scales", "--guidance_scales", dest="guide_scales",
                   type=float, nargs="+", default=None,
                   help="Guidance scales for generation")
    p.add_argument("--samples", "--samples_per_class", dest="samples",
                   type=int, default=None, help="Samples per class")
    p.add_argument("--no_eval", action="store_true",
                   help="Skip image quality evaluation")
    p.add_argument("--inception_weights", type=str, default=None,
                   help="torchvision inception_v3 state dict (.pt/.pth/.npz) "
                        "for real Inception FID; without it the in-loop "
                        "metric is reported as fid_proxy")
    p.add_argument("--save_dir", type=str, default=None,
                   help="train: where checkpoints, metrics and sample "
                        "grids go (default train.save_dir)")
    p.add_argument("--resume", type=str, default=None,
                   help="train: checkpoint (either package) to resume from")
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
    # crop mode
    p.add_argument("--img_dir", type=str, default=None)
    p.add_argument("--anno_dir", type=str, default=None)
    p.add_argument("--anno_format", type=str, default="voc",
                   choices=["voc", "datasetninja"])
    p.add_argument("--crop_out", type=str, default="./data/cropped_images1")
    p.add_argument("--crop_size", type=int, default=512)
    # eval mode (offline folder-vs-folder quality metrics)
    p.add_argument("--real_dir", type=str, default=None,
                   help="eval mode: directory of real images (flat or "
                        "one subdirectory per class)")
    p.add_argument("--gen_dir", type=str, default=None,
                   help="eval mode: directory of generated images")
    p.add_argument("--eval_out", type=str,
                   default="./output/eval_metrics.json",
                   help="eval mode: metrics JSON path")
    # visualize mode
    p.add_argument("--viz_out", type=str, default="dataset_visualization.png",
                   help="visualize mode: output sheet path")
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
                   help="img2img/inpaint: ldm (the latent-diffusion stack) "
                        "or main (the trained flagship, --ckpt, over DDIM)")
    p.add_argument("--mask_img", type=str, default=None,
                   help="main-family inpaint: keep-mask image (white = "
                        "preserve); default the bottom half")
    p.add_argument("--class_id", type=int, default=0,
                   help="main-family img2img/inpaint: the class label")
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
                   help="eval: common image size for SSIM/PSNR; train_ldm: "
                        "image size (a multiple of 8)")
    p.add_argument("--epochs", type=int, default=None,
                   help="train: epochs (unset: the preset's "
                        "train.n_epoch); train_ldm: epochs (unset or 0: 10, "
                        "as in the JAX package's CLI)")
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


def _config(args):
    """The preset with ``-o`` overrides and the flags that set config
    fields, as the JAX CLI builds it."""
    from diffusionmodel_tpu_torch.config import preset

    overrides = {}
    for item in args.override:
        k, _, v = item.partition("=")
        overrides[k] = _parse_value(v)
    cfg = preset(args.preset, **overrides)
    if args.data_root:
        cfg = cfg.replace(data_root=args.data_root)
    tc = cfg.train
    if args.save_dir:
        tc = dataclasses.replace(tc, save_dir=args.save_dir)
    if args.epochs is not None:  # unset keeps the preset's n_epoch
        tc = dataclasses.replace(tc, n_epoch=args.epochs)
    if args.seed is not None:
        tc = dataclasses.replace(tc, seed=args.seed)
    cfg = cfg.replace(train=tc)
    if args.sampler or args.steps:
        sc = cfg.sample
        if args.sampler:
            sc = dataclasses.replace(sc, sampler=args.sampler)
        if args.steps:
            # --steps targets whichever fast sampler is active
            if (args.sampler or sc.sampler) == "dpmpp":
                sc = dataclasses.replace(sc, dpm_steps=args.steps)
            else:
                sc = dataclasses.replace(sc, ddim_steps=args.steps)
        cfg = cfg.replace(sample=sc)
    return cfg


def _metrics(args):
    """``ImageMetrics`` with ``--inception_weights`` (None without the
    flag: the entry points build the proxy one on their device)."""
    if not args.inception_weights:
        return None
    if not os.path.isfile(args.inception_weights):
        raise FileNotFoundError(
            f"--inception_weights: no such file: {args.inception_weights}")
    from diffusionmodel_tpu_torch.metrics import ImageMetrics

    return ImageMetrics(inception_weights=args.inception_weights,
                        device=args.device)


def _train_dataset(args, cfg):
    """The side presets' datasets, with the JAX CLI's fallbacks: MNIST IDX
    files under ``data_root`` or a synthetic set (``mnist``), an image
    folder or a synthetic one (``labml``); None elsewhere (``fit`` reads
    the crack dataset at ``data_root``)."""
    if args.preset == "mnist":
        from diffusionmodel_tpu_torch.data import MnistDataset

        try:
            return MnistDataset(cfg.data_root)
        except FileNotFoundError:
            print("MNIST IDX files not found; using synthetic fallback")
            return MnistDataset(synthetic=True, n_synthetic=2048)
    if args.preset == "labml":
        # CelebA-style image folder (reference/ddpm/experiment.py:151-186)
        from diffusionmodel_tpu_torch.data import (
            ImageFolderDataset,
            SyntheticImageDataset,
        )

        mc = cfg.model
        try:
            return ImageFolderDataset(cfg.data_root, img_size=mc.img_size,
                                      channels=mc.in_ch,
                                      hflip_prob=cfg.train.hflip_prob)
        except (FileNotFoundError, NotADirectoryError):
            print(f"No image folder at {cfg.data_root}; "
                  "using synthetic fallback")
            return SyntheticImageDataset(n=512, img_size=mc.img_size,
                                         channels=mc.in_ch)
    return None


def _train_or_generate(args) -> int:
    """--mode train | generate, every preset."""
    cfg = _config(args)
    metrics_impl = _metrics(args)
    if args.mode == "train":
        from diffusionmodel_tpu_torch.trainer import _check_single_device, fit

        try:
            _check_single_device(cfg.train)
        except NotImplementedError as e:
            print(e)
            return 1
        fit(cfg, dataset=_train_dataset(args, cfg), metrics_impl=metrics_impl,
            resume=args.resume, device=args.device)
        return 0
    if args.ckpt is None:
        print("Error: Checkpoint path required for generation mode")
        return 1
    from diffusionmodel_tpu_torch.sample import gen_samples

    gen_samples(cfg, args.ckpt, n_samples_per_class=args.samples,
                guide_scales=args.guide_scales,
                eval_quality=not args.no_eval, metrics_impl=metrics_impl,
                seed=args.seed if args.seed is not None else 0,
                device=args.device)
    return 0


def _eval(args) -> int:
    """--mode eval: folder-vs-folder quality metrics to a JSON file."""
    import json

    from diffusionmodel_tpu_torch.metrics.folder_eval import evaluate_folders

    if not args.real_dir or not args.gen_dir:
        print("Error: --real_dir and --gen_dir required for eval mode")
        return 1
    out = evaluate_folders(args.real_dir, args.gen_dir, metrics=_metrics(args),
                           img_size=args.img_size, device=args.device)
    os.makedirs(os.path.dirname(args.eval_out) or ".", exist_ok=True)
    with open(args.eval_out, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out))
    print(f"Wrote {args.eval_out}")
    return 0


def _visualize(args) -> int:
    """--mode visualize: the dataset / mask inspection sheet
    (test_DroneDataset.py:8-94), written as a PNG (headless)."""
    from diffusionmodel_tpu_torch.data import CrackDataset
    from diffusionmodel_tpu_torch.data.visualize import (
        visualize_dataset_samples,
    )

    cfg = _config(args)
    dc = cfg.diffusion
    try:
        ds = CrackDataset(
            cfg.data_root, img_size=cfg.model.img_size,
            mask_values=(dc.low_weight, dc.mid_weight, dc.high_weight))
    except (FileNotFoundError, NotADirectoryError, OSError) as e:
        print(f"Error: no dataset at {cfg.data_root}: {e}")
        return 1
    if len(ds.samples) == 0:
        print(f"Error: no annotated samples found under {cfg.data_root}")
        return 1
    out = visualize_dataset_samples(
        ds, n_samples=args.samples or 5, out_path=args.viz_out,
        seed=cfg.train.seed)
    print(f"Wrote {out} ({min(args.samples or 5, len(ds.samples))} "
          "samples x 3 panels)")
    return 0


def _crop(args) -> int:
    """--mode crop: annotated images -> per-class crops + VOC XMLs."""
    from diffusionmodel_tpu_torch.data.crop_tool import (
        DatasetCropper,
        parse_datasetninja_dir,
        parse_voc_dir,
    )

    if not args.img_dir or not args.anno_dir:
        print("Error: --img_dir and --anno_dir required for crop mode")
        return 1
    parse = (parse_voc_dir if args.anno_format == "voc"
             else parse_datasetninja_dir)
    samples = parse(args.img_dir, args.anno_dir)
    cropper = DatasetCropper(samples, args.crop_out, args.crop_size)
    n = cropper.process_all(verbose=True)
    print(f"Cropped {n} objects into {args.crop_out}; "
          f"classes: {cropper.class_map}")
    return 0


def _edit_main(args) -> int:
    """--mode img2img | inpaint --family main: the trained flagship's
    editing over DDIM (``sample.edit_samples``)."""
    if args.ckpt is None or not args.orig_img:
        print("Error: --ckpt and --orig_img required for main-family "
              f"{args.mode}")
        return 1
    from diffusionmodel_tpu_torch.sample import edit_samples

    edit_samples(
        _config(args), args.ckpt, args.orig_img, mode=args.mode,
        class_id=args.class_id,
        guide_w=2.0 if args.scale is None else args.scale,
        strength=args.strength, n_steps=args.steps or 50,
        mask_path=args.mask_img, batch=args.batch_size,
        seed=args.seed if args.seed is not None else 0,
        out_dir=None if args.out_dir == "./output/ldm/" else args.out_dir,
        device=args.device)
    return 0


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
    _, history = fit_ldm(runner, images, prompts, epochs=args.epochs or 10,
                         batch_size=bs, lr=args.lr,
                         uncond_prob=args.uncond_prob, remat=args.remat,
                         seed=seed, out_path=out_path)
    print(json.dumps({"mode": "train_ldm", "images": len(ds),
                      "epochs": len(history),
                      "first_loss": round(history[0], 4),
                      "last_loss": round(history[-1], 4),
                      "ckpt": out_path}))
    return 0


_OTHER_MODES = {"eval": _eval, "visualize": _visualize, "crop": _crop}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.mode in ("img2img", "inpaint") and args.family == "main":
        return _edit_main(args)
    if args.mode in ("txt2img", "img2img", "inpaint"):
        return _ldm(args)
    if args.mode == "train_ldm":
        return _train_ldm(args)
    if args.mode in ("train", "generate"):
        return _train_or_generate(args)
    if args.mode in _OTHER_MODES:
        return _OTHER_MODES[args.mode](args)
    if args.ckpt is None:
        print("Error: Checkpoint path required for serve mode")
        return 1

    from diffusionmodel_tpu_torch.checkpoint import (
        extract_params,
        load_checkpoint,
    )
    from diffusionmodel_tpu_torch.compat.flax_bridge import load_flax
    from diffusionmodel_tpu_torch.device_check import resolve_device
    from diffusionmodel_tpu_torch.diffusion import Schedule
    from diffusionmodel_tpu_torch.nn import build_model
    from diffusionmodel_tpu_torch.serving import (
        SamplerService,
        make_http_server,
    )

    cfg = _config(args)
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
    ckpt = load_checkpoint(args.ckpt, arch=mc.arch, norm=mc.norm)
    bs = ckpt.get("batch_stats", {}) if isinstance(ckpt, dict) else {}
    model = build_model(mc, dc.high_thresh, device=device)
    load_flax(model, extract_params(ckpt), bs)
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
