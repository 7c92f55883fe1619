#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main paths at full width, with weights drawn from
fixed torch seeds: the ContextUnet serving path of ``preset("full")``
(ContextUnet v2, n_feat 192, 256 px, 5 classes, GroupNorm, 353M
parameters) with ``model.use_pallas=True``, so that SE and CoordAttn run
through the hand-written CUDA kernels; the latent-diffusion path
(``LdmRunner(arch="sd")``: the SD-v1 UNet, 860M parameters, and VAE at
512 px), whose level-0 self-attention runs through the hand-written
flash-attention kernel; and LDM training on that runner (``fit_ldm``,
``fit_ae``), whose backward runs the two hand-written flash-attention
backward kernels; and the flagship's own training and generation
(``trainer.fit``, ``sample.gen_samples``, ``cli --mode generate``), whose
eval passes run SE and CoordAttn through the kernels; and the quality
metrics on the flagship's generated images (``metrics.ImageMetrics``,
``cli --mode eval``). Phases, each printing JSON lines:

1. env      the card (nvidia-smi's name and power limit), torch/CUDA
            versions, and the TF32 settings, both switched off: every
            number here is float32.
2. build    nvcc for each kernel source, all in parallel: registers and
            spill bytes per kernel (ptxas), and the flash kernels'
            tensor-core instructions (cuobjdump -sass); fails if a flash
            kernel (six forward, twelve backward) spills or has no HMMA.
3. kernels  each kernel against its plain PyTorch twin at every site the
            flagship forward gives it at batch 16 (CoordAttn under both
            norm kinds): max |diff| (tolerance 1e-4 on standard-normal
            inputs: the same fp32 arithmetic summed in another order),
            kernel and twin times, and the least time the card could take;
            for CoordAttn also the profiler's device ms per pass and their
            sum, the kernels launched per call (must be its 3), and the
            shares of the bound and of the floor of a design that reads x
            twice.
4. flash    the flash-attention kernel against its twin (output and
            logsumexp) at the SD UNet's 512 px site (4, 4096, 8, 40), a
            ragged 416 px site, D = 80 and 160, an M != N case, the tiny
            and mid head dims and the training site (2, 4096, 8, 40, with
            L), then with q and k scaled by 3 (peaked softmaxes) at D = 40
            and 160: max |diff| (tolerance 1e-4 on standard-normal inputs:
            fp32-accurate products, each from three TF32 tensor-core
            products, summed in another order, with exp2 in place of exp),
            two runs bit-identical at the main site, kernel, twin and SDPA
            times, and two bounds by operations: 3xTF32 on the tensor cores
            (what the kernel runs) and fp32 on the CUDA cores.
5. forward  one full-width forward at batch 16 through the kernels against
            the plain path on the same weights (relative L2 tolerance
            1e-4), with 5 SE and 4 CoordAttn launches; then the device
            kernels of one eval CoordAttn module call, its packed weights
            cached (must be the kernel's 3).
6. serve    the ContextUnet main path, with every launch count zeroed just
            before it and PyTorch's TF32 defaults restored for the two
            services (their worker must turn TF32 off itself: a forward
            pre-hook records the flags every denoiser forward sees, and
            the phase fails unless both are off):
            ``SamplerService`` with DDIM-50 (mixed classes, two guidance
            scales, a pinned request alone and then batched with others,
            which must give the same images bit for bit, and one HTTP round
            trip), then DPM++-20, then the ancestral sampler over the last
            10 steps. Every image must be finite and of the right shape.
7. ldm_forward  the SD UNet at 512 px on a CFG batch of 4 through the
            kernel (5 launches: down_0_{0,1}, up_0_{0,1,2}) against the
            plain attention path on the same weights (relative L2
            tolerance 1e-4), device time per kernel name.
8. ldm      the latent-diffusion main path through ``LdmRunner``, with the
            launch counts zeroed just before it and PyTorch's TF32 defaults
            restored (the runner's calls must turn TF32 off themselves; the
            same hook and check as in serve): txt2img DDIM-50 at 512 px
            (batch 2, scale 7.5), txt2img DPM++-20, DDPM over its last 10
            steps, img2img and inpaint at strength 0.75. Images must be
            finite, [2, 512, 512, 3], and at least 98% of their values in
            [-1.5, 1.5]: a trained VAE keeps all of them in about [-1, 1];
            this random one gives values of std ~0.35-0.43 whose tail
            passes 1.5 (99.0-99.98% inside on an H100). Flash launches must
            be 5 per UNet forward.
9. flash_bwd  the dQ and dK/dV kernels against their plain twins at the
            training site (2, 4096, 4096, 8, 40) and the flash sites above:
            max |diff| over max |reference| (tolerance 1e-4: fp32-accurate
            sums over a whole sequence taken in another order, each
            product from three TF32 tensor-core products, exp2 in place of
            exp), the dQ pass's Delta (tolerance 1e-4 absolute), two runs
            bit-identical at the training site, each pass's time, its
            twin's, the backward of fp32 ``scaled_dot_product_attention``
            (timed only: the port never calls it), and two bounds by
            operations: 3xTF32 on the tensor cores (what the kernels run)
            and fp32 on the CUDA cores.
10. ldm_grad  one ``loss.backward()`` of the SD UNet at 512 px, batch 2,
            through the kernels against the plain attention path on the
            same weights and draws: relative L2 of the whole gradient
            (tolerance 1e-4) and of the level-0 attn1 projections, 5
            forward, 5 dQ and 5 dK/dV launches, and a profile: busy and
            idle share, the flash kernels' share of busy time.
11. train_ldm the training path, with the launch counts zeroed just before
            each run: ``fit_ldm`` on ``LdmRunner(arch="sd")`` at 512 px,
            batch 2, 8 synthetic images, 2 epochs (finite losses, 5
            launches of each kernel per step), its checkpoint reloaded by
            a new ``LdmRunner`` with a bit-identical UNet output, 2 steps
            with ``remat=True`` on images through the frozen VAE (10
            forward launches per step), and ``fit_ae`` for 2 steps at
            512 px. Seconds per step, images/s and peak memory.
12. train   ``trainer.fit`` on ``preset("full")`` at full width and depth
            (``use_pallas``, EMA 0.9995, batch 4 x 4 micro-batches, full
            remat, bf16 Adam moment, fp32) for 2 epochs on 25 in-memory
            synthetic crack images (5 classes; 20 train, 5 val), with
            validation and DPM++-10 sampling every epoch: finite losses,
            5 SE and 4 CoordAttn launches per eval-mode forward and none in
            train-mode ones (counted per forward by module hooks, the
            counts zeroed just before), the best checkpoint reloaded into a
            fresh model with a bit-identical output; then one more step,
            profiled (idle share), between two eval forwards: the second
            sees the new weights and matches the plain path on them
            (relative L2 1e-4). Seconds per optimizer step, trained
            images/s, peak memory (of the run, cuDNN's algorithm search
            included, and of the profiled step alone). ``fit`` scores every
            sampling epoch by default: its ``img_metrics`` must hold SSIM
            and PSNR (and fid_proxy where 10 eval images are collected;
            this run collects 5), with the seconds the scoring took.
13. generate ``gen_samples`` on the final checkpoint: 5 classes x 1
            sample, guide scales 2.0 and 4.0 in one sweep batch, DPM++-20
            (after an untimed one-step call that autotunes its shapes)
            (finite [5, 256, 256, 3] per scale, grids written, 5 / 4
            launches per forward, each scale scored against 4 dataset
            images into quality_metrics.json); the checkpoint's EMA
            weights in a kernel model and a plain one, eval forwards at
            batches 4, 20, 10, 4 (validation, the sweep's and fit's CFG
            batches; the kernel model's back to back on one stream), each
            within relative L2 1e-4 of the plain path; then ``python -m
            diffusionmodel_tpu_torch.cli --mode generate`` (DPM++-10) in a
            subprocess (its wall time includes the process start, the
            checkpoint load and cuDNN's search); seconds and images/s of
            both.
14. eval    the sweep's 10 images against the dataset's 25 through
            ``ImageMetrics()`` on the card (the proxy InceptionV3 at 299
            px, fp32, TF32 off): fid_proxy, kid_proxy_x1000, SSIM, PSNR,
            the first call's seconds, images/s at batch 8, the FID's host
            seconds (two float64 eigh of 2048 x 2048), and the trunk's
            batch-8 ms under cuDNN's heuristics and autotuned with the
            search's seconds; the same trunk on the CPU (features of 4
            images within relative L2 1e-4, ``evaluate_batch`` SSIM and
            PSNR equal, fid_proxy within 1e-4 relative); then ``python -m
            diffusionmodel_tpu_torch.cli --mode eval`` in a subprocess on
            the images written as PNG files (rc 0, n_real 25, n_gen 10,
            finite scores). The checkpoints are deleted afterwards.

Then a ``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises: the exit code is
not 0 and the last line is not printed. Without CUDA it exits 2 at once.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import re
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
TF32_FLOPS = 495e12  # H100 SXM dense TF32 on the tensor cores
TF32_PASSES = 3  # TF32 products per fp32-accurate product (3xTF32)
KERNEL_ATOL = 1e-4
FORWARD_RTOL = 1e-4
IMG_FRAC = 0.98  # share of decoded values that must lie in [-1.5, 1.5]
BATCH = 16  # the sampler's doubled CFG batch at max_batch 8
# (B, N, M, H, D) flash-attention sites: the SD UNet's level 0 at 512 px
# (CFG batch 4), 416 px (ragged: 52² tokens), D = 80 / 160 (SD levels 1
# and 2 at larger sizes), M != N, and the tiny / mid head dims.
FLASH_MAIN = (4, 4096, 4096, 8, 40)
FLASH_SITES = [FLASH_MAIN, (2, 2704, 2704, 8, 40), (2, 2304, 2304, 8, 80),
               (2, 2048, 2048, 8, 160), (2, 2048, 3000, 8, 40),
               (2, 4096, 4096, 2, 16), (4, 4096, 4096, 4, 32),
               (2, 4096, 4096, 4, 64)]
FLASH_PER_FORWARD = 5  # level-0 self-attentions of the SD UNet at 512 px
# The training site: the SD UNet's level 0 at 512 px and batch 2.
FLASH_TRAIN = (2, 4096, 4096, 8, 40)
# Sites run with q and k scaled by 3: sharply peaked softmaxes, where one
# TF32 product per fp32 product would miss KERNEL_ATOL.
FLASH_PEAKED = [(2, 4096, 4096, 8, 40), (2, 2048, 2048, 8, 160)]
BWD_RTOL = 1e-4  # backward kernels: max |diff| over max |reference|
GRAD_RTOL = 1e-4  # relative L2 of a whole UNet gradient, kernels vs plain
TRAIN_IMAGES, TRAIN_BATCH, TRAIN_EPOCHS = 8, 2, 2
# (H, C) of each site in one flagship forward, in forward order.
SE_SITES = [(256, 192), (256, 192), (128, 384), (64, 768), (32, 1536)]
CA_SITES = [(128, 192), (64, 384), (32, 768), (16, 1536)]
CA_KERNELS_PER_CALL = 3  # ca_pool, ca_bottleneck, ca_apply


def emit(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _kernel_events(fn) -> tuple:
    """Profile one call of ``fn`` (torch.profiler, CUDA activity): its
    kernels as (short name, start us, end us), with an event the profiler
    reports twice (same name and interval) once, and the wall ms of the
    call. The port's kernels go by their short names."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    seen = {}
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type != DeviceType.CUDA or end <= start \
                or (e.name, start, end) in seen:
            continue
        short = re.search(r"\b(?:se|ca)_[a-z_]+(?=[(<])|flash_(?:fwd|bwd_dq|"
                          r"bwd_dkv)<\d+(?:, ?(?:\d+|true|false))*>", e.name)
        seen[(e.name, start, end)] = short.group(0) if short else e.name[:80]
    return [(n, s, e) for (_, s, e), n in seen.items()], wall_ms


def kernel_breakdown(fn) -> tuple:
    """Profile one call of ``fn``: device ms per kernel name, the busy ms
    (the union of the kernels' intervals) and the wall ms of the call."""
    events, wall_ms = _kernel_events(fn)
    out = {}
    for name, start, end in events:
        out[name] = out.get(name, 0.0) + (end - start) / 1e3
    busy_us, reach = 0.0, float("-inf")
    for _, start, end in sorted(events, key=lambda s: s[1]):
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    return out, busy_us / 1e3, wall_ms


def kernel_launches(fn) -> dict:
    """Kernel launches per name over one call of ``fn``."""
    out = {}
    for name, _, _ in _kernel_events(fn)[0]:
        out[name] = out.get(name, 0) + 1
    return out


def device_times(fn) -> dict:
    """Device ms per CUDA kernel name over one call of ``fn``."""
    return kernel_breakdown(fn)[0]


def bound(nbytes: float, flops: float, rate: float = FP32_FLOPS):
    """Least time in ms: bytes over HBM rate vs ops over the peak ``rate``
    (fp32 on the CUDA cores unless given)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def bound_3xtf32(nbytes: float, flops: float):
    """Least time in ms of fp32-accurate products formed as 3xTF32 on the
    tensor cores: three TF32 products per fp32 product."""
    return bound(nbytes, TF32_PASSES * flops, TF32_FLOPS)


def phase_env() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    before = {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
              "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit("env", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), tf32_default=before,
         tf32_set={"cudnn.allow_tf32": False,
                   "cuda.matmul.allow_tf32": False})
    return {"nvidia_smi": smi, "tf32_default": before}


class _EntryPointFlags:
    """For a stretch that drives an entry point which must set its own
    precision: ``start`` restores PyTorch's TF32 defaults (as ``phase_env``
    found them) and puts a forward pre-hook on ``module`` that records the
    flags (cuDNN TF32, cuBLAS TF32) each of its forwards sees; ``stop``
    removes the hook and turns TF32 off again for this script's process."""

    def __init__(self, module, defaults: dict):
        self.module, self.defaults, self.seen = module, defaults, []

    def start(self):
        torch.backends.cudnn.allow_tf32 = self.defaults["cudnn.allow_tf32"]
        torch.backends.cuda.matmul.allow_tf32 = \
            self.defaults["cuda.matmul.allow_tf32"]

        def pre(mod, args):
            self.seen.append((torch.backends.cudnn.allow_tf32,
                              torch.backends.cuda.matmul.allow_tf32))

        self._hook = self.module.register_forward_pre_hook(pre)
        return self

    def stop(self) -> None:
        self._hook.remove()
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def summary(self) -> dict:
        return {"defaults": self.defaults, "forwards": len(self.seen),
                "first_forward": self.seen[0] if self.seen else None,
                "forwards_with_tf32": sum(a or b for a, b in self.seen)}

    def check(self, what: str) -> None:
        check(bool(self.seen) and self.seen[0] == (False, False)
              and not any(a or b for a, b in self.seen),
              f"{what}: the denoiser ran with TF32 on {self.summary()}")


def _flash_name(mangled: re.Match) -> str:
    """flash_bwd_dkv<40,32,0> from the mangled ``flash_bwd_dkvILi40ELi32ELb0EE``
    (template arguments: the head dim first, then the tile shape)."""
    return "%s<%s>" % (mangled.group(1),
                       ",".join(re.findall(r"L[ib](\d+)E", mangled.group(2))))


_FLASH_MANGLED = r"(flash_(?:fwd|bwd_dq|bwd_dkv))I((?:L[ib]\d+E)+)E"


def _sass_mma(lib_path) -> dict:
    """Per flash kernel in the built library, its tensor-core instructions
    by ``cuobjdump -sass``: the count of HMMA lines and the first one.
    Empty where the toolkit has no cuobjdump."""
    import os
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out = {}
    for chunk in sass.split("Function : ")[1:]:
        name = re.search(_FLASH_MANGLED, chunk.split("\n", 1)[0])
        if not name:
            continue
        hmma = re.findall(r"HMMA[^;]*", chunk)
        out[_flash_name(name)] = {"hmma": len(hmma),
                                  "first": hmma[0] if hmma else None}
    return out


def phase_build() -> None:
    from diffusionmodel_tpu_torch.kernels import _build
    from diffusionmodel_tpu_torch.kernels.flash_attn import HEAD_DIMS

    t0 = time.monotonic()
    report = _build.build()
    regs, spills = {}, {}
    for r in report.values():  # ptxas -v: registers and spills per kernel
        for chunk in r["log"].split("Function properties for ")[1:]:
            fn = re.search(r"(?:se|ca)_[a-z_]+(?:ILi\d+E)?(?=E)", chunk)
            flash = re.search(_FLASH_MANGLED, chunk)
            used = re.search(r"Used (\d+) registers", chunk)
            spill = re.search(r"(\d+) bytes spill stores", chunk)
            if flash and used:
                regs[_flash_name(flash)] = int(used.group(1))
                spills[_flash_name(flash)] = int(spill.group(1)) if spill else 0
            elif fn and used:
                regs[re.sub(r"ILi(\d+)E", r"<\1>", fn.group(0))] = int(
                    used.group(1))
    sass = {**_sass_mma(_build.library_path("flash_attn")),
            **_sass_mma(_build.library_path("flash_attn_bwd"))}
    emit("build", seconds=time.monotonic() - t0,
         per_source={k: v["seconds"] for k, v in report.items()},
         registers=regs, spill_store_bytes=spills, flash_sass_hmma=sass)
    flash = {name: (name.split("<")[0], int(name.split("<")[1].split(",")[0]))
             for name in spills if name.startswith("flash_")}
    check(sorted(flash.values()) == sorted(
        (f"flash_{p}", d) for p in ("fwd", "bwd_dq", "bwd_dkv")
        for d in HEAD_DIMS),
        f"one forward, dQ and dK/dV kernel per head dim: {sorted(flash)}")
    check(all(spills[name] == 0 for name in flash),
          f"flash kernels spill: {spills}")
    check(not sass or all(sass.get(name, {}).get("hmma", 0) > 0
                          for name in flash),
          f"flash kernels without tensor-core (HMMA) instructions: {sass}")


def _site_x(b, h, c, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((b, h, h, c), generator=g, device="cuda")


def ca_site_weights(i: int, c: int, kind: str):
    """Packed weights of a CoordAttn module at CoordAttn site ``i`` (random
    from fixed seeds, the norms and gates drawn too) and its group count."""
    from diffusionmodel_tpu_torch.kernels.coord_attn import CoordAttnWeights
    from diffusionmodel_tpu_torch.nn.blocks import gn_groups
    from diffusionmodel_tpu_torch.nn.coord_attn import CoordAttn

    r = c // 16
    torch.manual_seed(200 + i)
    mod = CoordAttn(c, 16, norm="group" if kind == "group"
                    else "batch").cuda().eval()
    g = torch.Generator(device="cuda").manual_seed(300 + i)
    with torch.no_grad():
        for p in (mod.gamma_h, mod.gamma_w, mod.alpha, mod.beta):
            p.copy_(torch.randn(1, generator=g, device="cuda"))
        for nl in (mod.bn1_h, mod.bn1_w):
            nl.weight.copy_(1 + 0.1 * torch.randn(
                r, generator=g, device="cuda"))
            nl.bias.copy_(0.1 * torch.randn(r, generator=g, device="cuda"))
            if kind == "affine":
                nl.running_mean.copy_(0.1 * torch.randn(
                    r, generator=g, device="cuda"))
                nl.running_var.copy_(torch.rand(
                    r, generator=g, device="cuda") + 0.5)
        return CoordAttnWeights.from_module(mod, kind), gn_groups(r, 8)


def ca_site_row(x, wts, kind: str, groups: int, iters: int = 20) -> dict:
    """The CoordAttn kernel at one site: max |kernel - twin|, the CUDA-event
    ms of back-to-back wrapper calls, the profiler's device ms per kernel,
    their sum and the union of their intervals (the passes overlap: each
    may start while the one before it ends, and waits for its output), the
    host's ms per call (the wrapper's enqueue; where it nears ``ms`` the
    host sets the pace), the CoordAttn kernels launched per call, the
    bound (x
    read once, out written once, the operations at the fp32 rate) and the
    floor of a design that reads x twice, and the shares of both."""
    from diffusionmodel_tpu_torch.kernels.coord_attn import (
        coord_attn,
        coord_attn_plain,
    )

    def call():
        return coord_attn(x, wts, kind, groups)

    with torch.no_grad():
        err = (call() - coord_attn_plain(x, wts, kind, groups)
               ).abs().max().item()
        b, h, _, c = x.shape
        r = wts.w1h.shape[-1]
        xb = x.numel() * 4
        wbytes = sum(getattr(wts, f.name).numel() * 4
                     for f in dataclasses.fields(wts))
        mlp = b * 2 * h * (2 * c * r + 2 * r * r + 2 * r * c)
        b_ms, b_by = bound(2 * xb + wbytes, 4 * x.numel() + mlp)
        ms = cuda_ms(call, iters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            call()
        host_ms = (time.perf_counter() - t0) * 1e3 / iters
        torch.cuda.synchronize()
        by_kernel, busy_ms, _ = kernel_breakdown(call)
        per_kernel = {k: v for k, v in by_kernel.items() if k.startswith("ca_")}
        launched = sum(n for k, n in kernel_launches(call).items()
                       if k.startswith("ca_"))
    floor_ms = 3 * xb / HBM_BYTES_PER_S * 1e3
    return dict(shape=list(x.shape), norm_kind=kind, max_abs_err=err, ms=ms,
                device_ms=per_kernel, device_sum_ms=sum(per_kernel.values()),
                device_busy_ms=busy_ms, host_ms=host_ms,
                kernels_per_call=launched,
                bound_ms=b_ms, bound_by=b_by, design_bound_ms=floor_ms,
                bound_share=b_ms / ms, design_bound_share=floor_ms / ms)


def check_ca_row(row: dict) -> None:
    check(row["max_abs_err"] <= KERNEL_ATOL,
          f"coord_attn {row['norm_kind']} {row['shape']}: "
          f"|diff| {row['max_abs_err']}")
    check(row["kernels_per_call"] == CA_KERNELS_PER_CALL,
          f"coord_attn {row['shape']}: {row['kernels_per_call']} kernels "
          f"per call, the design launches {CA_KERNELS_PER_CALL}")


def phase_kernels() -> list:
    from diffusionmodel_tpu_torch.kernels.coord_attn import coord_attn_plain
    from diffusionmodel_tpu_torch.kernels.se_block import (
        se_block,
        se_block_plain,
    )

    rows = {"se_block": [], "coord_attn": [], "coord_attn_affine": []}
    with torch.no_grad():
        for i, (h, c) in enumerate(SE_SITES):
            r = c // 16
            x = _site_x(BATCH, h, c, i)
            g = torch.Generator(device="cuda").manual_seed(100 + i)
            w1 = torch.randn((c, r), generator=g, device="cuda") / c ** 0.5
            w2 = torch.randn((r, c), generator=g, device="cuda") / r ** 0.5
            err = (se_block(x, w1, w2) - se_block_plain(x, w1, w2)
                   ).abs().max().item()
            xb = x.numel() * 4
            b_ms, b_by = bound(2 * xb + 2 * c * r * 4,
                               3 * x.numel() + 4 * BATCH * c * r)
            rows["se_block"].append(dict(
                shape=list(x.shape), max_abs_err=err,
                ms=cuda_ms(lambda: se_block(x, w1, w2), 20),
                plain_ms=cuda_ms(lambda: se_block_plain(x, w1, w2), 10),
                device_ms=device_times(lambda: se_block(x, w1, w2)),
                bound_ms=b_ms, bound_by=b_by,
                design_bound_ms=3 * xb / HBM_BYTES_PER_S * 1e3))
            emit("kernels", kernel="se_block", **rows["se_block"][-1])
            check(err <= KERNEL_ATOL, f"se_block {x.shape}: |diff| {err}")
            del x

        for kind, key in (("group", "coord_attn"),
                          ("affine", "coord_attn_affine")):
            for i, (h, c) in enumerate(CA_SITES):
                wts, groups = ca_site_weights(i, c, kind)
                x = _site_x(BATCH, h, c, 10 + i)
                rows[key].append(ca_site_row(x, wts, kind, groups))
                rows[key][-1]["plain_ms"] = cuda_ms(
                    lambda: coord_attn_plain(x, wts, kind, groups), 10)
                emit("kernels", kernel="coord_attn", **rows[key][-1])
                check_ca_row(rows[key][-1])
                del x
    return rows


def _flagship(use_pallas: bool):
    from diffusionmodel_tpu_torch.config import preset
    from diffusionmodel_tpu_torch.nn import build_model

    cfg = preset("full", **{"model.use_pallas": use_pallas})
    torch.manual_seed(0)
    return cfg, build_model(cfg.model, cfg.diffusion.high_thresh,
                            device="cuda")


def phase_forward(counters):
    from diffusionmodel_tpu_torch.nn.coord_attn import CoordAttn

    cfg, model = _flagship(True)
    _, plain = _flagship(False)
    plain.load_state_dict(model.state_dict())
    n_params = sum(p.numel() for p in model.parameters())
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((BATCH, 256, 256, 3), generator=g, device="cuda")
    c = torch.arange(BATCH, device="cuda") % cfg.model.n_classes
    t = torch.rand(BATCH, generator=g, device="cuda")
    ctx = (torch.arange(BATCH, device="cuda") >= BATCH // 2).float()
    with torch.no_grad():
        before = [f.launches for f in counters]
        got = model(x, c, t, ctx)
        torch.cuda.synchronize()
        launched = [f.launches - b for f, b in zip(counters, before)]
        want = plain(x, c, t, ctx)
        rel = ((got - want).norm() / want.norm()).item()
        times = {}
        for name, m in (("kernel_path", model), ("plain_path", plain),
                        ("kernel_path_2", model), ("plain_path_2", plain)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m(x, c, t, ctx)
            torch.cuda.synchronize()
            times[name] = (time.perf_counter() - t0) * 1e3
        by_kernel = device_times(lambda: model(x, c, t, ctx))
        # one eval CoordAttn module call, its packed weights cached: every
        # device kernel it launches (the kernel's three passes, no packing)
        ca = next(m for m in model.modules() if isinstance(m, CoordAttn))
        h = 256 // 2
        xa = torch.randn((BATCH, ca.conv_h.out_channels, h, h),
                         generator=g, device="cuda").contiguous(
                             memory_format=torch.channels_last)
        ca_module_kernels = kernel_launches(lambda: ca(xa))
        del xa
    total = sum(by_kernel.values())
    ours = sum(v for k, v in by_kernel.items() if k[:3] in ("se_", "ca_"))
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    emit("forward", device_ms=total, se_ca_device_ms=ours,
         top_kernels=[[k, v] for k, v in top])
    emit("forward", params=n_params, shape=list(got.shape),
         se_launches=launched[0], ca_launches=launched[1],
         ca_module_kernels=ca_module_kernels, rel_l2=rel,
         max_abs_err=(got - want).abs().max().item(),
         max_abs_out=want.abs().max().item(), ms=times)
    check(n_params > 300e6, f"flagship has {n_params} parameters")
    check(tuple(got.shape) == (BATCH, 256, 256, 3)
          and bool(torch.isfinite(got).all()), "forward output")
    check(launched == [5, 4], f"launches per forward {launched}")
    check(sum(ca_module_kernels.values()) == CA_KERNELS_PER_CALL,
          f"device kernels per eval CoordAttn call {ca_module_kernels}")
    check(rel <= FORWARD_RTOL, f"forward relative L2 {rel}")
    del plain
    torch.cuda.empty_cache()
    return cfg, model


def _finite(imgs, n):
    return imgs.shape == (n, 256, 256, 3) and bool(np.isfinite(imgs).all())


def _http_round_trip(svc):
    from diffusionmodel_tpu_torch.serving import make_http_server

    httpd = make_http_server(svc, host="127.0.0.1", port=0,
                             class_names=[f"class_{i}" for i in range(5)])
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        body = json.dumps({"classes": ["class_2", 3], "guide_w": 4.0,
                           "seed": 5}).encode()
        req = urllib.request.Request(f"{url}/generate", data=body,
                                     headers={"Content-Type":
                                              "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            pngs = [base64.b64decode(s) for s in json.loads(r.read())["images"]]
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    check(len(pngs) == 2 and all(
        p[:8] == b"\x89PNG\r\n\x1a\n" and p[16:24] == (256).to_bytes(4, "big")
        * 2 for p in pngs), "HTTP /generate returned two 256x256 PNGs")
    check(health["status"] == "ok", "HTTP /healthz")
    return health["stats"]


def phase_serve(cfg, model, counters, env) -> list:
    from diffusionmodel_tpu_torch.diffusion import Schedule, sample_cfg
    from diffusionmodel_tpu_torch.serving import SamplerService

    dc = cfg.diffusion
    sched = Schedule.create(dc.beta1, dc.beta2, dc.n_T, "cuda")
    for f in counters:
        f.launches = 0
    t_serve = time.perf_counter()
    # the services under PyTorch's TF32 defaults: their worker must run the
    # denoiser fp32 on its own
    flags = _EntryPointFlags(model, env["tf32_default"]).start()

    with SamplerService(model, cfg, sched, max_batch=8, sampler="ddim",
                        service_seed=0) as svc:
        t0 = time.perf_counter()
        alone = svc.generate([0, 1, 2], guide_w=2.0, seed=1234)
        alone_s = time.perf_counter() - t0
        n0 = svc.stats["batches"]
        t0 = time.perf_counter()
        futs = [svc.submit([3, 4], guide_w=4.0),
                svc.submit([0, 1, 2], guide_w=2.0, seed=1234),
                svc.submit([4, 0, 1], guide_w=4.0, seed=99)]
        outs = [f.result(timeout=900) for f in futs]
        batched_s = time.perf_counter() - t0
        batched_runs = svc.stats["batches"] - n0
        http_stats = _http_round_trip(svc)
        st = dict(svc.stats)
    pin_err = float(np.abs(outs[1] - alone).max())
    emit("serve", sampler="ddim", steps=cfg.sample.ddim_steps, max_batch=8,
         pinned_alone_vs_batched_max_abs=pin_err, batched_runs=batched_runs,
         alone_s=alone_s, batched_s=batched_s,
         images_per_s=st["slots_used"] / st["busy_seconds"],
         slot_images_per_s=st["slots_dispatched"] / st["busy_seconds"],
         stats=st, http_stats=http_stats)
    check(_finite(alone, 3) and all(_finite(o, len(o)) for o in outs),
          "DDIM images finite, [n,256,256,3]")
    check(batched_runs == 1, f"three requests took {batched_runs} batches")
    check(pin_err == 0.0, f"pinned request moved by {pin_err} when batched")

    with SamplerService(model, cfg, sched, max_batch=8, sampler="dpmpp",
                        service_seed=0) as svc:
        t0 = time.perf_counter()
        imgs = svc.generate([0, 1, 2, 3, 4, 0, 1, 2], guide_w=3.0, seed=7)
        dpm_s = time.perf_counter() - t0
    emit("serve", sampler="dpmpp", steps=cfg.sample.dpm_steps, max_batch=8,
         seconds=dpm_s, images_per_s=8 / dpm_s)
    check(_finite(imgs, 8), "DPM++ images finite, [8,256,256,3]")
    flags.stop()
    emit("serve", run="precision", **flags.summary())
    flags.check("serve")

    x_init = np.random.default_rng(3).standard_normal(
        (8, 256, 256, 3), np.float32)
    t0 = time.perf_counter()
    tail = sample_cfg(model, None, 8, (256, 256, 3), cfg.model.n_classes,
                      sched, dc, guide_w=torch.full((8,), 2.0),
                      classes=torch.arange(8) % 5, steps=range(10, 0, -1),
                      x_init=x_init, slot_seeds=list(range(8))).cpu().numpy()
    tail_s = time.perf_counter() - t0
    emit("serve", sampler="ancestral", steps=10, max_batch=8,
         seconds=tail_s, images_per_s=8 / tail_s)
    check(_finite(tail, 8), "ancestral images finite, [8,256,256,3]")

    torch.cuda.synchronize()
    launches = [f.launches for f in counters]
    forwards = 3 * cfg.sample.ddim_steps + cfg.sample.dpm_steps + 10
    emit("serve", seconds=time.perf_counter() - t_serve, forwards=forwards,
         se_launches=launches[0], ca_launches=launches[1],
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    check(launches == [5 * forwards, 4 * forwards],
          f"main-path launches {launches} for {forwards} forwards")
    return launches

def phase_flash() -> list:
    import torch.nn.functional as F

    from diffusionmodel_tpu_torch.kernels.flash_attn import (
        flash_attention,
        flash_attention_plain,
    )

    rows = []
    cases = ([(site, False, 1.0) for site in FLASH_SITES]
             + [(FLASH_TRAIN, True, 1.0)]
             + [(site, False, 3.0) for site in FLASH_PEAKED])
    with torch.no_grad():
        for i, ((b, n, m, h, d), lse_out, scale) in enumerate(cases):
            g = torch.Generator(device="cuda").manual_seed(500 + i)
            q = scale * torch.randn((b, n, h, d), generator=g, device="cuda")
            k = scale * torch.randn((b, m, h, d), generator=g, device="cuda")
            v = torch.randn((b, m, h, d), generator=g, device="cuda")
            o, lse = flash_attention(q, k, v, want_lse=True)
            ref_o, ref_lse = flash_attention_plain(q, k, v, want_lse=True)
            err = (o - ref_o).abs().max().item()
            err_lse = (lse - ref_lse).abs().max().item()
            row = dict(shape=[b, n, m, h, d], scale=scale, want_lse=lse_out,
                       max_abs_err=err, max_abs_err_lse=err_lse)
            if (b, n, m, h, d) == FLASH_MAIN:  # fixed order: bit-identical
                o2, lse2 = flash_attention(q, k, v, want_lse=True)
                row["repeat_bit_identical"] = (torch.equal(o, o2)
                                               and torch.equal(lse, lse2))
                del o2, lse2
            del o, lse, ref_o, ref_lse
            check(max(err, err_lse) <= KERNEL_ATOL,
                  f"flash_attn {[b, n, m, h, d]} x{scale}: |diff| {err}, "
                  f"lse {err_lse}")
            check(row.get("repeat_bit_identical", True),
                  f"flash_attn {[b, n, m, h, d]}: two runs differ")
            if scale == 1.0:
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                iters = 10 if b * n * m * h * d >= 2 ** 32 else 3
                nbytes = 4 * (2 * b * n * h * d + 2 * b * m * h * d
                              + (b * h * n if lse_out else 0))
                flops = 4 * b * h * n * m * d
                b_ms, b_by = bound_3xtf32(nbytes, flops)
                fp32_ms = bound(nbytes, flops)[0]
                row.update(
                    ms=cuda_ms(lambda: flash_attention(q, k, v, lse_out),
                               iters),
                    plain_ms=cuda_ms(lambda: flash_attention_plain(
                        q, k, v, lse_out), iters),
                    library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                        qt, kt, vt), iters),
                    device_ms=device_times(
                        lambda: flash_attention(q, k, v, lse_out)),
                    bound_ms=b_ms, bound_by=b_by, bound_ms_fp32=fp32_ms)
                row.update(bound_share=b_ms / row["ms"],
                           bound_share_fp32=fp32_ms / row["ms"])
                del qt, kt, vt
            rows.append(row)
            emit("flash", **row)
            del q, k, v
    torch.cuda.empty_cache()
    return rows


def _sd_unet(seed: int):
    from diffusionmodel_tpu_torch.models.latent_diffusion.runner import ARCHS
    from diffusionmodel_tpu_torch.models.latent_diffusion.unet import (
        UNetModel,
    )

    a = {k: v for k, v in ARCHS["sd"].items() if not k.startswith("ae_")}
    torch.manual_seed(seed)
    with torch.device("cuda"):
        unet = UNetModel(**a)
    return unet.to(memory_format=torch.channels_last).eval()


def phase_ldm_forward(flash) -> None:
    unet = _sd_unet(0)
    n_params = sum(p.numel() for p in unet.parameters())
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((4, 64, 64, 4), generator=g, device="cuda")
    t = torch.tensor([981, 981, 500, 21], device="cuda")
    cond = torch.randn((4, 77, 768), generator=g, device="cuda")
    with torch.no_grad():
        before = flash.launches
        got = unet(x, t, cond)
        torch.cuda.synchronize()
        launched = flash.launches - before
        unet.set_use_flash(False)
        want = unet(x, t, cond)
        rel = ((got - want).norm() / want.norm()).item()
        times = {}
        for name, on in (("kernel_path", True), ("plain_path", False),
                         ("kernel_path_2", True), ("plain_path_2", False)):
            unet.set_use_flash(on)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            unet(x, t, cond)
            torch.cuda.synchronize()
            times[name] = (time.perf_counter() - t0) * 1e3
        unet.set_use_flash(True)
        event_ms = cuda_ms(lambda: unet(x, t, cond), 3)
        by_kernel, busy_ms, wall_ms = kernel_breakdown(
            lambda: unet(x, t, cond))
    total = sum(by_kernel.values())
    ours = sum(v for k, v in by_kernel.items() if k.startswith("flash_fwd"))
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    emit("ldm_forward", device_ms=total, event_ms=event_ms,
         busy_ms=busy_ms, wall_ms=wall_ms, idle_share=1.0 - busy_ms / wall_ms,
         flash_device_ms=ours,
         top_kernels=[[k, v] for k, v in top])
    emit("ldm_forward", params=n_params, shape=list(got.shape),
         flash_launches=launched, rel_l2=rel,
         max_abs_err=(got - want).abs().max().item(),
         max_abs_out=want.abs().max().item(), ms=times)
    check(n_params > 800e6, f"SD UNet has {n_params} parameters")
    check(tuple(got.shape) == (4, 64, 64, 4)
          and bool(torch.isfinite(got).all()), "SD UNet output")
    check(launched == FLASH_PER_FORWARD,
          f"flash launches per SD UNet forward: {launched}")
    check(rel <= FORWARD_RTOL, f"SD UNet relative L2 {rel}")
    del unet, got, want
    torch.cuda.empty_cache()


def _check_images(imgs, what) -> dict:
    finite = bool(np.isfinite(imgs).all())
    inside = float((np.abs(imgs) <= 1.5).mean())
    check(imgs.shape == (2, 512, 512, 3) and finite,
          f"{what}: images finite, [2,512,512,3], got {imgs.shape}")
    check(inside >= IMG_FRAC, f"{what}: {inside:.5f} of values in [-1.5, 1.5]")
    return dict(shape=list(imgs.shape), min=float(imgs.min()),
                max=float(imgs.max()), std=float(imgs.std()),
                share_in_1p5=inside)


def phase_ldm(flash, env) -> int:
    from diffusionmodel_tpu_torch.models.latent_diffusion.runner import (
        LdmRunner,
    )

    t0 = time.perf_counter()
    runner = LdmRunner(arch="sd", device="cuda", verbose=False)
    emit("ldm", build_s=time.perf_counter() - t0)
    # the runner's calls under PyTorch's TF32 defaults: each must run fp32
    flags = _EntryPointFlags(runner.unet, env["tf32_default"]).start()
    img = np.random.default_rng(11).uniform(
        -1, 1, (2, 512, 512, 3)).astype(np.float32)
    torch.cuda.reset_peak_memory_stats()
    flash.launches = 0
    t_all = time.perf_counter()
    runs = [("txt2img", "ddim", 50, 50), ("txt2img", "dpmpp", 20, 20),
            ("txt2img", "ddpm", 50, 10), ("img2img", "ddim", 50, 37),
            ("inpaint", "ddim", 50, 37)]
    forwards = 0
    for mode, sampler, steps, n_fwd in runs:
        runner.sampler_name, runner.steps = sampler, steps
        g = torch.Generator(device="cuda").manual_seed(forwards)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode == "txt2img":
            out = runner.txt2img("a road with a long crack", batch_size=2,
                                 uncond_scale=7.5, generator=g,
                                 skip_steps=990 if sampler == "ddpm" else 0)
        else:
            fn = runner.img2img if mode == "img2img" else runner.inpaint
            out = fn(img, "a road with a long crack", strength=0.75,
                     generator=g)
        sec = time.perf_counter() - t0
        forwards += n_fwd
        emit("ldm", mode=mode, sampler=sampler, unet_forwards=n_fwd,
             seconds=sec, images_per_s=2 / sec,
             **_check_images(out, f"{mode}/{sampler}"))
    torch.cuda.synchronize()
    launches = flash.launches
    flags.stop()
    emit("ldm", run="precision", **flags.summary())
    flags.check("ldm")
    emit("ldm", seconds=time.perf_counter() - t_all, unet_forwards=forwards,
         flash_launches=launches,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    check(launches == FLASH_PER_FORWARD * forwards,
          f"flash launches {launches} for {forwards} UNet forwards")
    del runner
    torch.cuda.empty_cache()
    return launches


def _bwd_inputs(b, n, m, h, d, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, n, h, d), generator=g, device="cuda")
    k = torch.randn((b, m, h, d), generator=g, device="cuda")
    v = torch.randn((b, m, h, d), generator=g, device="cuda")
    do = torch.randn((b, n, h, d), generator=g, device="cuda")
    return q, k, v, do


def _rel_max(got, want) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


def phase_flash_bwd() -> list:
    """The two backward kernels against their twins; per site and pass the
    numbers a kernels-line entry needs."""
    import torch.nn.functional as F

    from diffusionmodel_tpu_torch.kernels.flash_attn import (
        flash_attention,
        flash_attention_dkv,
        flash_attention_dkv_plain,
        flash_attention_dq,
        flash_attention_dq_plain,
    )

    rows = []
    for i, (b, n, m, h, d) in enumerate([FLASH_TRAIN] + FLASH_SITES):
        q, k, v, do = _bwd_inputs(b, n, m, h, d, 700 + i)
        with torch.no_grad():
            o, lse = flash_attention(q, k, v, want_lse=True)
            dq, delta = flash_attention_dq(q, k, v, o, lse, do)
            dk, dv = flash_attention_dkv(q, k, v, do, lse, delta)
            want_dq, want_delta = flash_attention_dq_plain(q, k, v, o, lse, do)
            want_dk, want_dv = flash_attention_dkv_plain(q, k, v, do, lse,
                                                         want_delta)
            errs = {"dq": _rel_max(dq, want_dq), "dk": _rel_max(dk, want_dk),
                    "dv": _rel_max(dv, want_dv)}
            abs_errs = {"dq": (dq - want_dq).abs().max().item(),
                        "dk": (dk - want_dk).abs().max().item(),
                        "dv": (dv - want_dv).abs().max().item()}
            err_delta = (delta - want_delta).abs().max().item()
            repeat = {}
            if (b, n, m, h, d) == FLASH_TRAIN:  # fixed order: bit-identical
                dq2, delta2 = flash_attention_dq(q, k, v, o, lse, do)
                dk2, dv2 = flash_attention_dkv(q, k, v, do, lse, delta2)
                repeat = {"repeat_bit_identical": all(
                    torch.equal(x, y) for x, y in ((dq, dq2), (delta, delta2),
                                                   (dk, dk2), (dv, dv2)))}
                del dq2, delta2, dk2, dv2
            del dq, dk, dv, want_dq, want_dk, want_dv, want_delta
            torch.cuda.empty_cache()
            iters = 10 if (b, n, m, h, d) == FLASH_TRAIN else 3
            ms_dq = cuda_ms(lambda: flash_attention_dq(q, k, v, o, lse, do),
                            iters)
            ms_dkv = cuda_ms(lambda: flash_attention_dkv(q, k, v, do, lse,
                                                         delta), iters)
            plain_dq = cuda_ms(lambda: flash_attention_dq_plain(
                q, k, v, o, lse, do), iters)
            plain_dkv = cuda_ms(lambda: flash_attention_dkv_plain(
                q, k, v, do, lse, delta), iters)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt)
        dot = do.transpose(1, 2)
        library_ms = cuda_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True), iters)
        del out, qt, kt, vt
        prod = 2 * b * h * n * m * d  # flops of one [N,M,D] product
        qb, kb, rb = 4 * b * n * h * d, 4 * b * m * h * d, 4 * b * h * n
        bytes_dq = 3 * qb + 2 * kb + rb + qb + rb
        bytes_dkv = 2 * qb + 2 * kb + 2 * rb + 2 * kb
        # the kernels' bound (3xTF32 on the tensor cores), and beside it the
        # fp32 CUDA-core bound the first design was held to
        bound_dq = bound_3xtf32(bytes_dq, 3 * prod)
        bound_dkv = bound_3xtf32(bytes_dkv, 4 * prod)
        fp32_dq = bound(bytes_dq, 3 * prod)
        fp32_dkv = bound(bytes_dkv, 4 * prod)
        rows.append(dict(
            shape=[b, n, m, h, d], max_rel_err=errs, max_abs_err=abs_errs,
            max_abs_err_delta=err_delta, **repeat, ms_dq=ms_dq, ms_dkv=ms_dkv,
            plain_ms_dq=plain_dq, plain_ms_dkv=plain_dkv,
            library_ms_backward=library_ms,
            bound_ms_dq=bound_dq[0], bound_by_dq=bound_dq[1],
            bound_ms_dkv=bound_dkv[0], bound_by_dkv=bound_dkv[1],
            bound_share_dq=bound_dq[0] / ms_dq,
            bound_share_dkv=bound_dkv[0] / ms_dkv,
            bound_ms_dq_fp32=fp32_dq[0], bound_ms_dkv_fp32=fp32_dkv[0],
            bound_share_dq_fp32=fp32_dq[0] / ms_dq,
            bound_share_dkv_fp32=fp32_dkv[0] / ms_dkv))
        emit("flash_bwd", **rows[-1])
        check(max(errs.values()) <= BWD_RTOL and err_delta <= KERNEL_ATOL,
              f"flash backward {[b, n, m, h, d]}: {errs}, delta {err_delta}")
        check(repeat.get("repeat_bit_identical", True),
              f"flash backward {[b, n, m, h, d]}: two runs differ")
        del q, k, v, do, o, lse, delta
        torch.cuda.empty_cache()
    return rows


def _counts(counters) -> list:
    return [f.launches for f in counters]


def phase_ldm_grad(counters) -> None:
    """One backward of the SD UNet at 512 px through the kernels against
    the plain attention path, same weights and draws."""
    from diffusionmodel_tpu_torch.models.latent_diffusion.latent_diffusion import (  # noqa: E501
        ldm_schedule,
    )
    from diffusionmodel_tpu_torch.models.latent_diffusion.training import (
        ldm_loss,
    )

    unet = _sd_unet(0)
    sched = ldm_schedule(device="cuda")
    g = torch.Generator(device="cuda").manual_seed(13)
    z0 = 0.18215 * torch.randn((TRAIN_BATCH, 64, 64, 4), generator=g,
                               device="cuda")
    cond = torch.randn((TRAIN_BATCH, 77, 768), generator=g, device="cuda")
    t = torch.tensor([981, 21], device="cuda")
    eps = torch.randn(z0.shape, generator=g, device="cuda")
    attn1 = unet.input_blocks[1][1].transformer_blocks[0].attn1
    projections = {n: getattr(attn1, n).weight for n in ("to_q", "to_k",
                                                        "to_v")}
    grads, losses, times = [], [], {}
    for name, flash in (("kernel_path", True), ("plain_path", False)):
        unet.set_use_flash(flash)
        unet.zero_grad(set_to_none=True)
        for f in counters:
            f.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = ldm_loss(unet, z0, cond, sched, t=t, eps=eps)
        loss.backward()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        launched = _counts(counters)
        check(launched == ([FLASH_PER_FORWARD] * 3 if flash else [0, 0, 0]),
              f"ldm_grad {name}: launches {launched}")
        losses.append(loss.item())
        grads.append({k: p.grad for k, p in unet.named_parameters()})
        unet.zero_grad(set_to_none=True)
    for name, flash in (("kernel_path_2", True), ("plain_path_2", False)):
        unet.set_use_flash(flash)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ldm_loss(unet, z0, cond, sched, t=t, eps=eps).backward()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        unet.zero_grad(set_to_none=True)
    unet.set_use_flash(True)

    def step():
        ldm_loss(unet, z0, cond, sched, t=t, eps=eps).backward()
        unet.zero_grad(set_to_none=True)

    by_kernel, busy_ms, wall_ms = kernel_breakdown(step)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    flash_ms = {k: v for k, v in by_kernel.items() if k.startswith("flash_")}
    emit("ldm_grad", profile="kernel path, loss + backward",
         device_ms=sum(by_kernel.values()), busy_ms=busy_ms, wall_ms=wall_ms,
         idle_share=1.0 - busy_ms / wall_ms, flash_ms=flash_ms,
         flash_share_of_busy=sum(flash_ms.values()) / busy_ms,
         top_kernels=[[k, v] for k, v in top])
    on, off = grads
    diff2 = sum((on[k] - off[k]).square().sum() for k in off).item()
    ref2 = sum(g.square().sum() for g in off.values()).item()
    rel = (diff2 / ref2) ** 0.5
    proj = {}
    for n, w in projections.items():
        key = next(k for k, p in unet.named_parameters() if p is w)
        proj[n] = dict(norm=off[key].norm().item(),
                       rel_l2=((on[key] - off[key]).norm()
                               / off[key].norm()).item())
    emit("ldm_grad", batch=TRAIN_BATCH, losses=losses, rel_l2=rel,
         attn1_level0=proj, ms=times,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    check(abs(losses[0] - losses[1]) <= 1e-4 * abs(losses[1]),
          f"ldm_grad losses {losses}")
    check(rel <= GRAD_RTOL, f"ldm_grad relative L2 {rel}")
    check(all(v["norm"] > 0 and v["rel_l2"] <= 1e-3 for v in proj.values()),
          f"level-0 attn1 projection gradients {proj}")
    del unet, grads, on, off
    torch.cuda.empty_cache()


def _train_images() -> tuple:
    """8 synthetic 512 px images in [-1, 1] (smooth random fields, made from
    a numpy seed) and a prompt for each, two classes."""
    rng = np.random.default_rng(21)
    low = rng.standard_normal((TRAIN_IMAGES, 16, 16, 3)).astype(np.float32)
    img = np.tanh(low.repeat(32, axis=1).repeat(32, axis=2)
                  + 0.1 * rng.standard_normal(
                      (TRAIN_IMAGES, 512, 512, 3)).astype(np.float32))
    prompts = [f"a photo of a {'crack' if i % 2 else 'pothole'}"
               for i in range(TRAIN_IMAGES)]
    return img, prompts


def phase_train_ldm(counters) -> list:
    """The LDM training path through ``LdmRunner(arch="sd")``; returns the
    backward kernels' launches in its runs (forward, dQ, dK/dV)."""
    import os
    import shutil

    from diffusionmodel_tpu_torch.models.latent_diffusion.runner import (
        LdmRunner,
    )
    from diffusionmodel_tpu_torch.models.latent_diffusion.training import (
        fit_ae,
        fit_ldm,
        make_ldm_train_step,
    )

    images, prompts = _train_images()
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "output", "chip_smoke")
    ckpt = os.path.join(out_dir, "ldm_native.pkl")
    runner = LdmRunner(arch="sd", device="cuda", verbose=False)
    steps_per_epoch = TRAIN_IMAGES // TRAIN_BATCH
    marks = []
    torch.cuda.reset_peak_memory_stats()
    for f in counters:
        f.launches = 0
    t0 = time.perf_counter()
    state, history = fit_ldm(
        runner, images, prompts, epochs=TRAIN_EPOCHS, batch_size=TRAIN_BATCH,
        lr=1e-4, uncond_prob=0.1, seed=0, out_path=ckpt,
        log=lambda msg: marks.append((time.perf_counter(), msg)))
    fit_s = time.perf_counter() - t0
    fit_launches = _counts(counters)
    fit_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # the second epoch's four steps, timed between the two epoch logs
    step_s = (marks[1][0] - marks[0][0]) / steps_per_epoch
    save_s = marks[2][0] - marks[1][0]
    emit("train_ldm", run="fit_ldm", images=TRAIN_IMAGES,
         batch=TRAIN_BATCH, epochs=TRAIN_EPOCHS, steps=state.steps,
         history=history, seconds=fit_s, seconds_per_step=step_s,
         images_per_s=TRAIN_BATCH / step_s, checkpoint_write_s=save_s,
         launches=fit_launches, peak_mem_gib=fit_peak)
    check(state.steps == TRAIN_EPOCHS * steps_per_epoch
          and len(history) == TRAIN_EPOCHS
          and all(np.isfinite(history)), f"fit_ldm history {history}")
    check(fit_launches == [FLASH_PER_FORWARD * state.steps] * 3,
          f"fit_ldm launches {fit_launches} for {state.steps} steps")

    t0 = time.perf_counter()
    loaded = LdmRunner(arch="sd", device="cuda", verbose=False, seed=7,
                       native_ckpt=ckpt)
    load_s = time.perf_counter() - t0
    g = torch.Generator(device="cuda").manual_seed(17)
    x = torch.randn((TRAIN_BATCH, 64, 64, 4), generator=g, device="cuda")
    t = torch.tensor([500, 20], device="cuda")
    cond = runner.cond(prompts[:TRAIN_BATCH])
    with torch.no_grad():
        same = torch.equal(runner.unet(x, t, cond), loaded.unet(x, t, cond))
    size_gib = os.path.getsize(ckpt) / 2 ** 30
    emit("train_ldm", run="checkpoint", bytes_gib=size_gib,
         load_s=load_s, unet_output_bit_identical=same)
    check(same, "reloaded checkpoint gives another UNet output")
    del loaded
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    step = make_ldm_train_step(runner.unet, state.opt, ae=runner.ae,
                               uncond_prob=0.1, remat=True)
    batch = torch.from_numpy(images[:TRAIN_BATCH]).cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    torch.cuda.reset_peak_memory_stats()
    for f in counters:
        f.launches = 0
    losses, secs = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(batch, cond, uncond_cond=runner.cond([""])[0],
                           generator=gen).item())
        secs.append(time.perf_counter() - t0)
    remat_launches = _counts(counters)
    emit("train_ldm", run="remat_steps", losses=losses, seconds=secs,
         images_per_s=TRAIN_BATCH / secs[-1], launches=remat_launches,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    check(all(np.isfinite(losses)), f"remat losses {losses}")
    check(remat_launches == [4 * FLASH_PER_FORWARD, 2 * FLASH_PER_FORWARD,
                             2 * FLASH_PER_FORWARD],
          f"remat launches {remat_launches} for 2 steps")
    del step, state, batch
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ae_state, ae_hist = fit_ae(runner.ae, images[:2 * TRAIN_BATCH], epochs=1,
                               batch_size=TRAIN_BATCH, lr=1e-4, seed=0,
                               log=lambda msg: None)
    ae_s = time.perf_counter() - t0
    emit("train_ldm", run="fit_ae", steps=ae_state.steps, history=ae_hist,
         seconds=ae_s, peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    check(ae_state.steps == 2 and all(np.isfinite(list(h.values())).all()
                                      for h in ae_hist),
          f"fit_ae history {ae_hist}")
    del runner, ae_state
    torch.cuda.empty_cache()
    return [a + b for a, b in zip(fit_launches, remat_launches)]


# --- flagship training and generation ------------------------------------
FLAGSHIP_CLASSES = 5
FLAGSHIP_PER_CLASS = 5  # 25 in-memory images: 20 train, 5 val
FLAGSHIP_EPOCHS = 2
SE_PER_FORWARD, CA_PER_FORWARD = len(SE_SITES), len(CA_SITES)


def _synthetic_crack_dataset(img_size: int, mask_values):
    """An in-memory crack dataset: ``FLAGSHIP_PER_CLASS`` images per class
    (smooth random fields with a dark crack-like streak), each with a
    random box in 512 px original coordinates, through the port's
    ``CrackDataset.from_arrays`` (its ``load`` / ``load_wire``, masks from
    ``build_attn_mask``). Needs no files and no imaging package."""
    from diffusionmodel_tpu_torch.data import CrackDataset

    rng = np.random.default_rng(31)
    images, boxes, labels = [], [], []
    for k in range(FLAGSHIP_CLASSES):
        for _ in range(FLAGSHIP_PER_CLASS):
            low = rng.uniform(0, 255, (8, 8, 3))
            img = low.repeat(img_size // 8, 0).repeat(img_size // 8, 1)
            x0, y0 = rng.integers(32, 300, 2)
            w, h = rng.integers(64, 200, 2)
            s = img_size / 512
            img[int(y0 * s):int((y0 + h) * s),
                int((x0 + w // 2) * s):int((x0 + w // 2) * s) + 4] = 20
            images.append(np.clip(img, 0, 255).astype(np.uint8))
            boxes.append((int(x0), int(y0), int(x0 + w), int(y0 + h)))
            labels.append(k)
    return CrackDataset.from_arrays(
        np.stack(images), boxes, labels,
        [f"crack_{k}" for k in range(FLAGSHIP_CLASSES)], orig_wh=(512, 512),
        mask_values=mask_values, hflip_prob=0.5, co_flip_mask=True)


class _ForwardLaunches:
    """Counts, per ContextUnet forward, the SE and CoordAttn kernel
    launches it made, split by the module's mode (train / eval), through
    global module hooks; ``close()`` removes them."""

    def __init__(self, counters):
        from torch.nn.modules.module import (
            register_module_forward_hook,
            register_module_forward_pre_hook,
        )

        from diffusionmodel_tpu_torch.nn.context_unet import ContextUnet

        self.counters, self._open = counters, {}
        self.per_forward = {"train": [], "eval": []}

        def pre(module, args):
            if isinstance(module, ContextUnet):
                self._open[id(module)] = _counts(counters)

        def post(module, args, out):
            if isinstance(module, ContextUnet):
                start = self._open.pop(id(module))
                self.per_forward["train" if module.training else "eval"] \
                    .append(tuple(b - a for a, b in
                                  zip(start, _counts(counters))))

        self._hooks = [register_module_forward_pre_hook(pre),
                       register_module_forward_hook(post)]

    def summary(self) -> dict:
        return {mode: {"forwards": len(v),
                       "launches_per_forward": sorted(set(v))}
                for mode, v in self.per_forward.items()}

    def close(self):
        for h in self._hooks:
            h.remove()


def _flagship_train_cfg(out_dir):
    from diffusionmodel_tpu_torch.config import preset

    return preset("full", **{
        "model.use_pallas": True, "train.ema_decay": 0.9995,
        "sample.sampler": "dpmpp", "sample.dpm_steps": 10,
        "train.n_epoch": FLAGSHIP_EPOCHS, "train.eval_every": 1,
        "train.min_save_ep": 0, "train.val_split": 0.2,
        "train.save_dir": f"{out_dir}/run",
        "sample.sample_dir": f"{out_dir}/samples"})


def _flagship_eval_forward(model, seed=23):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((4, 256, 256, 3), generator=g, device="cuda")
    c = torch.arange(4, device="cuda") % FLAGSHIP_CLASSES
    t = torch.rand(4, generator=g, device="cuda")
    with torch.no_grad():
        return model.eval()(x, c, t, torch.ones(4, device="cuda"))


def _rel_l2(got, want) -> float:
    return ((got - want).norm() / want.norm()).item()


def phase_train(counters, out_dir) -> tuple:
    """``trainer.fit`` on ``preset("full")`` at full width; returns the
    config, the final checkpoint's path, the launches of the run and the
    dataset."""
    import json
    import os

    from diffusionmodel_tpu_torch.checkpoint import (
        extract_params,
        load_checkpoint,
    )
    from diffusionmodel_tpu_torch.compat.flax_bridge import (
        state_dict_from_flax,
    )
    from diffusionmodel_tpu_torch.data import BatchLoader, stratified_split
    from diffusionmodel_tpu_torch.device_check import fp32_compute
    from diffusionmodel_tpu_torch.diffusion import Schedule
    from diffusionmodel_tpu_torch.metrics import ImageMetrics
    from diffusionmodel_tpu_torch.nn import build_model
    from diffusionmodel_tpu_torch.train import build_optimizer, make_train_step
    from diffusionmodel_tpu_torch.trainer import fit

    cfg = _flagship_train_cfg(out_dir)
    tc, dc = cfg.train, cfg.diffusion
    dataset = _synthetic_crack_dataset(
        256, (dc.low_weight, dc.mid_weight, dc.high_weight))
    watch = _ForwardLaunches(counters)
    metric_s = []  # seconds of each quality scoring inside fit
    scoring = ImageMetrics.evaluate_batch

    def timed(self, real, gen):
        t = time.perf_counter()
        try:
            return scoring(self, real, gen)
        finally:
            metric_s.append(time.perf_counter() - t)

    torch.cuda.reset_peak_memory_stats()
    for f in counters:
        f.launches = 0
    ImageMetrics.evaluate_batch = timed
    t0 = time.perf_counter()
    try:
        state = fit(cfg, dataset=dataset, verbose=False, device="cuda")
        torch.cuda.synchronize()
    finally:
        ImageMetrics.evaluate_batch = scoring
    fit_s = time.perf_counter() - t0
    launches = _counts(counters)
    watch.close()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    run = f"{out_dir}/run"
    last = f"metrics_ep{FLAGSHIP_EPOCHS - 1}.json"
    log = json.load(open(os.path.join(run, "metrics", last)))
    per_step = 1.0 / log["steps_per_sec"][-1]
    batch = tc.batch_size * tc.accum_steps
    seen = watch.summary()
    emit("train", params=sum(p.numel() for p in state.model.parameters()),
         images=len(dataset), epochs=FLAGSHIP_EPOCHS, steps=state.step,
         batch=[tc.accum_steps, tc.batch_size], remat=tc.remat_policy,
         moment_dtype=tc.moment_dtype, train_loss=log["train_loss"],
         val_loss=log["val_loss"], lr=log["lr"],
         steps_per_sec=log["steps_per_sec"], seconds_per_step=per_step,
         images_per_s=batch / per_step, fit_s=fit_s, peak_mem_gib=peak,
         se_launches=launches[0], ca_launches=launches[1], forwards=seen,
         files=sorted(os.listdir(run)))
    check(all(np.isfinite(log["train_loss"] + log["val_loss"])),
          f"finite losses {log}")
    check(state.step == FLAGSHIP_EPOCHS * 2, f"{state.step} optimizer steps")
    check(seen["eval"]["launches_per_forward"] == [(SE_PER_FORWARD,
                                                    CA_PER_FORWARD)]
          and seen["train"]["launches_per_forward"] == [(0, 0)]
          and seen["train"]["forwards"] > 0,
          f"launches per forward by mode {seen}")
    check(launches == [SE_PER_FORWARD * seen["eval"]["forwards"],
                       CA_PER_FORWARD * seen["eval"]["forwards"]],
          f"train launches {launches} for {seen}")
    # quality scored every sampling epoch: SSIM and PSNR of the collected
    # validation images (fid_proxy from 10 of them; this run collects 5)
    scored = log["img_metrics"]
    n_eval = min(tc.eval_sample_count, len(stratified_split(
        dataset.labels, tc.val_split, tc.split_seed)[1]))
    want_keys = {"ssim", "psnr", "guide_scale", "epoch", "images_per_min"} \
        | ({"fid_proxy"} if n_eval >= 10 else set())
    emit("train", run="img_metrics", eval_images=n_eval,
         scoring_s=sum(metric_s), scorings=len(metric_s), img_metrics=scored)
    check(len(scored) == FLAGSHIP_EPOCHS * len(cfg.sample.guide_scales)
          and all(set(m) == want_keys and all(np.isfinite(m[k]) for k in
                                              want_keys) for m in scored),
          f"fit's img_metrics {scored}")

    # the best checkpoint (what fit leaves loaded), reloaded into a fresh
    # model: a bit-identical eval output through the kernels
    kept = _flagship_eval_forward(state.model)
    ck = load_checkpoint(os.path.join(run, "best_model"))
    torch.manual_seed(1)
    fresh = build_model(cfg.model, dc.high_thresh, device="cuda")
    fresh.load_state_dict(state_dict_from_flax(extract_params(
        ck, prefer_ema=False), ck["batch_stats"]))
    same = torch.equal(_flagship_eval_forward(fresh), kept)
    final = load_checkpoint(os.path.join(run, f"ckpt_ep{FLAGSHIP_EPOCHS - 1}"))
    emit("train", run="checkpoint", best_epoch=int(ck["epoch"]),
         eval_output_bit_identical=same, final_epoch=int(final["epoch"]),
         final_opt_count=int(final["opt_state"]["count"]))
    check(same, "the reloaded best checkpoint gives another output")
    check(final["opt_state"]["count"] == state.step
          and final["ema_params"] is not None, "final checkpoint contents")
    del fresh, ck, final

    # one more optimizer step, profiled, between two eval forwards through
    # the kernels: the second must see the new weights (CoordAttn's cached
    # packing follows the in-place update) and match the plain path
    # (at fit's settings: TF32 off, cuDNN's algorithms autotuned)
    step = make_train_step(state.model, Schedule.create(
        dc.beta1, dc.beta2, dc.n_T, "cuda"), cfg,
        build_optimizer(cfg, state.step // FLAGSHIP_EPOCHS))
    loader = BatchLoader(dataset, np.arange(len(dataset)), tc.batch_size,
                         tc.accum_steps, seed=2, num_workers=0)
    one = next(iter(loader))
    gen = torch.Generator(device="cuda").manual_seed(3)
    with fp32_compute(torch.device("cuda")):
        before = _flagship_eval_forward(state.model)
        watch = _ForwardLaunches(counters)
        torch.cuda.reset_peak_memory_stats()
        by_kernel, busy_ms, wall_ms = kernel_breakdown(
            lambda: step(state, one, gen))
        steady_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        watch.close()
        after = _flagship_eval_forward(state.model)
        torch.manual_seed(1)
        plain = build_model(dataclasses.replace(cfg.model, use_pallas=False),
                            dc.high_thresh, device="cuda")
        plain.load_state_dict(state.model.state_dict())
        rel = _rel_l2(after, _flagship_eval_forward(plain))
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    emit("train", run="profiled_step", wall_ms=wall_ms, busy_ms=busy_ms,
         idle_share=1.0 - busy_ms / wall_ms, peak_mem_gib=steady_peak,
         device_ms=sum(by_kernel.values()), top_kernels=[[k, v]
                                                         for k, v in top],
         train_forwards=watch.summary()["train"],
         kernel_vs_plain_rel_l2=rel,
         moved_rel_l2=_rel_l2(after, before))
    check(watch.summary()["train"]["launches_per_forward"] == [(0, 0)],
          "train-mode forwards launched a kernel")
    check(rel <= FORWARD_RTOL, f"trained weights: kernel vs plain {rel}")
    check(not torch.equal(after, before), "the step did not move the output")
    del plain, step, state
    torch.cuda.empty_cache()
    return (cfg, os.path.join(run, f"ckpt_ep{FLAGSHIP_EPOCHS - 1}"),
            launches, dataset)


GENERATE_BATCHES = (4, 20, 10, 4)  # validation, sweep CFG, in-loop CFG


def _generation_batches_match(cfg, ckpt) -> dict:
    """The checkpoint's EMA weights (what ``gen_samples`` samples with) in
    a kernel model and a plain one: eval forwards at the batches the
    generation paths give the kernels (the sweep's CFG batch of 20, fit's
    in-loop CFG batch of 10, the batch-4 validation), the kernel model's
    run back to back on one stream so each call reuses the workspace of a
    call at another batch; each output against the plain path's on the
    same inputs (relative L2)."""
    from diffusionmodel_tpu_torch.checkpoint import (
        extract_params,
        load_checkpoint,
    )
    from diffusionmodel_tpu_torch.compat.flax_bridge import (
        state_dict_from_flax,
    )
    from diffusionmodel_tpu_torch.device_check import fp32_compute
    from diffusionmodel_tpu_torch.nn import build_model

    ck = load_checkpoint(ckpt)
    sd = state_dict_from_flax(extract_params(ck), ck["batch_stats"])
    del ck
    models = {}
    for use_pallas in (True, False):
        torch.manual_seed(1)
        models[use_pallas] = build_model(
            dataclasses.replace(cfg.model, use_pallas=use_pallas),
            cfg.diffusion.high_thresh, device="cuda").eval()
        models[use_pallas].load_state_dict(sd)
    g = torch.Generator(device="cuda").manual_seed(29)
    size = cfg.model.img_size
    inputs = []
    for b in GENERATE_BATCHES:
        x = torch.randn((b, size, size, 3), generator=g, device="cuda")
        t = torch.rand(b, generator=g, device="cuda")
        c = torch.arange(b, device="cuda") % FLAGSHIP_CLASSES
        # a CFG batch: the second half has its context dropped
        ctx = (torch.arange(b, device="cuda") < max(b // 2, 1)).float()
        inputs.append((x, c, t, ctx))
    with fp32_compute(torch.device("cuda")), torch.no_grad():
        got = [models[True](*a) for a in inputs]
        want = [models[False](*a) for a in inputs]
    rel = [_rel_l2(a, b) for a, b in zip(got, want)]
    del models, got, want
    torch.cuda.empty_cache()
    return {"batches": list(GENERATE_BATCHES), "kernel_vs_plain_rel_l2": rel}


def phase_generate(counters, cfg, ckpt, out_dir, dataset) -> tuple:
    """``gen_samples`` on the trained checkpoint (5 classes x 1 sample,
    guide scales 2.0 and 4.0 in one sweep batch, DPM++-20, scored against
    4 of the dataset's images), then the CLI's ``--mode generate`` in a
    subprocess (DPM++-10). Returns the launches and the sweep's 10
    images."""
    import os
    import sys as _sys

    from diffusionmodel_tpu_torch.sample import gen_samples

    # one DPM++ step first, untimed: cuDNN's algorithm search for the
    # sweep's batch-20 shapes (about a minute) stays out of the timing
    gen_samples(cfg.replace(sample=dataclasses.replace(cfg.sample,
                                                       dpm_steps=1)),
                ckpt, n_samples_per_class=1, guide_scales=[2.0, 4.0],
                eval_quality=False, verbose=False, device="cuda")
    cfg = cfg.replace(sample=dataclasses.replace(cfg.sample, dpm_steps=20))
    watch = _ForwardLaunches(counters)
    for f in counters:
        f.launches = 0
    t0 = time.perf_counter()
    res = gen_samples(cfg, ckpt, n_samples_per_class=1,
                      guide_scales=[2.0, 4.0], eval_quality=True,
                      dataset=dataset, verbose=False, device="cuda")
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = _counts(counters)
    watch.close()
    seen = watch.summary()
    n_img = 2 * FLAGSHIP_CLASSES
    sweep_s = res[2.0]["seconds"] * 2
    emit("generate", sampler="dpmpp", steps=20, images=n_img,
         sweep_seconds=sweep_s, images_per_s=n_img / sweep_s,
         call_seconds=gen_s, se_launches=launches[0],
         ca_launches=launches[1], forwards=seen,
         files=sorted(os.listdir(res["out_dir"])))
    quality_file = os.path.join(res["out_dir"], "quality_metrics.json")
    emit("generate", run="quality", quality=res["quality"])
    for w in (2.0, 4.0):
        imgs = res[w]["images"]
        check(imgs.shape == (FLAGSHIP_CLASSES, 256, 256, 3)
              and bool(np.isfinite(imgs).all())
              and os.path.exists(res[w]["grid_path"]),
              f"generate images at scale {w}")
        check(set(res["quality"].get(w, {})) == {"ssim", "psnr"}
              and all(np.isfinite(v) for v in res["quality"][w].values())
              and os.path.exists(quality_file),
              f"generate quality at scale {w}: {res['quality']}")
    check(seen["eval"]["forwards"] == 20
          and seen["eval"]["launches_per_forward"] == [(SE_PER_FORWARD,
                                                        CA_PER_FORWARD)]
          and launches == [SE_PER_FORWARD * 20, CA_PER_FORWARD * 20],
          f"generate launches {launches}, {seen}")
    match = _generation_batches_match(cfg, ckpt)
    emit("generate", run="kernel_vs_plain", **match)
    check(all(r <= FORWARD_RTOL for r in match["kernel_vs_plain_rel_l2"]),
          f"generation batches: kernel vs plain {match}")

    cli_dir = f"{out_dir}/cli_samples"
    cmd = [_sys.executable, "-m", "diffusionmodel_tpu_torch.cli", "--mode",
           "generate", "--ckpt", ckpt, "--sampler", "dpmpp", "--steps", "10",
           "--samples", "1", "--no_eval", "--device", "cuda",
           "-o", "model.use_pallas=true",
           "-o", f"sample.sample_dir={cli_dir}"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    cli_s = time.perf_counter() - t0
    made = sorted(os.listdir(os.path.join(cli_dir, os.listdir(cli_dir)[0]))) \
        if proc.returncode == 0 and os.path.isdir(cli_dir) else []
    emit("generate", run="cli", returncode=proc.returncode, seconds=cli_s,
         images_per_s=n_img / cli_s, files=made,
         stderr_tail=proc.stderr[-2000:])
    check(proc.returncode == 0 and len(made) == n_img + 2,
          f"cli --mode generate: rc {proc.returncode}, files {made}")
    return launches, np.concatenate([res[2.0]["images"], res[4.0]["images"]])


def _rel_l2_np(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def phase_eval(gen, dataset, out_dir) -> dict:
    """The sweep's 10 generated images scored against the dataset's 25 by
    ``ImageMetrics()`` on the card (the proxy InceptionV3 trunk at 299 px,
    fp32 with TF32 off, cuDNN's heuristics), the same trunk on the CPU,
    then ``cli --mode eval`` on the images written as PNG files."""
    import json
    import os

    from diffusionmodel_tpu_torch.device_check import fp32_compute
    from diffusionmodel_tpu_torch.metrics import ImageMetrics
    from diffusionmodel_tpu_torch.metrics.image_metrics import (
        calc_psnr,
        calc_ssim,
        frechet_distance,
        kid_from_feats,
        resize_to_299,
    )
    from diffusionmodel_tpu_torch.utils.grid import save_image

    t_phase = time.perf_counter()
    real = np.stack([dataset.load(i)[0] for i in range(len(dataset))])
    im = ImageMetrics()
    t0 = time.perf_counter()
    rf = im.extract_features(real)  # builds the trunk; first cuDNN calls
    first_s = time.perf_counter() - t0
    gf = im.extract_features(gen)
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        im.extract_features(real[:24])  # three batches of 8
    images_per_s = reps * 24 / (time.perf_counter() - t0)
    rf, gf = rf.astype(np.float64), gf.astype(np.float64)
    t0 = time.perf_counter()
    fid = frechet_distance(rf.mean(0), np.cov(rf, rowvar=False),
                           gf.mean(0), np.cov(gf, rowvar=False))
    fid_host_s = time.perf_counter() - t0
    kid, kid_std = kid_from_feats(rf, gf)
    pairs = list(zip(real, gen))
    scores = {"fid_proxy": fid, "kid_proxy_x1000": kid * 1000,
              "kid_proxy_x1000_std": kid_std * 1000,
              "ssim": float(np.mean([calc_ssim(r, g) for r, g in pairs])),
              "psnr": float(np.mean([calc_psnr(r, g) for r, g in pairs]))}
    # cuDNN's search for the trunk's shapes at batch 8: its one-off cost
    # against what it saves per batch. cuDNN keeps the plan it took for a
    # shape per thread, searched or not, so the autotuned pass runs in a
    # thread of its own.
    x8 = resize_to_299(torch.from_numpy((real[:8] + 1) / 2).cuda())
    with torch.no_grad(), fp32_compute(torch.device("cuda"),
                                       autotune=False):
        heuristic_ms = cuda_ms(lambda: im.inception(x8), 5)
    tuned = {}

    def autotuned():
        with torch.no_grad(), fp32_compute(torch.device("cuda")):
            torch.cuda.synchronize()
            t = time.perf_counter()
            im.inception(x8)
            torch.cuda.synchronize()
            tuned["search_s"] = time.perf_counter() - t
            tuned["ms"] = cuda_ms(lambda: im.inception(x8), 5)

    worker = threading.Thread(target=autotuned)
    worker.start()
    worker.join()
    search_s, tuned_ms = tuned["search_s"], tuned["ms"]
    del x8
    emit("eval", real=len(real), generated=len(gen), **scores,
         features_first_call_s=first_s, images_per_s_batch8=images_per_s,
         fid_host_s=fid_host_s, trunk_batch8_ms_heuristics=heuristic_ms,
         trunk_batch8_ms_autotuned=tuned_ms, autotune_search_s=search_s)
    check(rf.shape == (25, 2048) and gf.shape == (10, 2048)
          and all(np.isfinite(v) for v in scores.values()),
          f"eval scores {scores}")

    # the same extractor on the CPU (the proxy's weights are drawn on the
    # host): features of the same 4 images, then the dispatcher on both
    cpu = ImageMetrics(device="cpu")
    rel = _rel_l2_np(rf[:4], cpu.extract_features(real[:4]))
    on_card = im.evaluate_batch(real[:10], gen)
    on_cpu = cpu.evaluate_batch(real[:10], gen)
    fid_rel = abs(on_card["fid_proxy"] - on_cpu["fid_proxy"]) \
        / abs(on_cpu["fid_proxy"])
    emit("eval", run="card_vs_cpu", features_rel_l2=rel, card=on_card,
         cpu=on_cpu, fid_rel_diff=fid_rel)
    check(rel <= FORWARD_RTOL, f"card vs CPU features: relative L2 {rel}")
    check(on_card["ssim"] == on_cpu["ssim"]
          and on_card["psnr"] == on_cpu["psnr"] and fid_rel <= FORWARD_RTOL,
          f"evaluate_batch card vs CPU {on_card} {on_cpu}")

    # the CLI on PNG files: real images in class folders, generated flat
    real_dir, gen_dir = f"{out_dir}/eval_real", f"{out_dir}/eval_gen"
    for i, img in enumerate(real):
        d = os.path.join(real_dir, dataset.classes[dataset.samples[i][2]])
        os.makedirs(d, exist_ok=True)
        save_image(img, os.path.join(d, f"{i}.png"), denorm=True)
    os.makedirs(gen_dir, exist_ok=True)
    for i, img in enumerate(gen):
        save_image(img, os.path.join(gen_dir, f"{i}.png"), denorm=True)
    out_json = f"{out_dir}/eval_metrics.json"
    cmd = [sys.executable, "-m", "diffusionmodel_tpu_torch.cli", "--mode",
           "eval", "--device", "cuda", "--real_dir", real_dir, "--gen_dir",
           gen_dir, "--eval_out", out_json]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    cli_s = time.perf_counter() - t0
    doc = json.load(open(out_json)) if proc.returncode == 0 else {}
    emit("eval", run="cli", returncode=proc.returncode, seconds=cli_s,
         result=doc, stderr_tail=proc.stderr[-2000:])
    keys = ("fid_proxy", "kid_proxy_x1000", "ssim", "psnr")
    check(proc.returncode == 0 and doc.get("n_real") == 25
          and doc.get("n_gen") == 10
          and all(np.isfinite(doc.get(k, np.nan)) for k in keys),
          f"cli --mode eval: rc {proc.returncode}, {doc}")
    emit("eval", seconds=time.perf_counter() - t_phase)
    return scores


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from diffusionmodel_tpu_torch.kernels.coord_attn import coord_attn
    from diffusionmodel_tpu_torch.kernels.flash_attn import (
        flash_attention,
        flash_attention_dkv,
        flash_attention_dq,
    )
    from diffusionmodel_tpu_torch.kernels.se_block import se_block

    counters = [se_block, coord_attn]
    env = phase_env()
    phase_build()
    rows = phase_kernels()
    flash_rows = phase_flash()
    cfg, model = phase_forward(counters)
    launches = phase_serve(cfg, model, counters, env)
    del model
    torch.cuda.empty_cache()
    phase_ldm_forward(flash_attention)
    flash_launches = phase_ldm(flash_attention, env)
    flash_counters = [flash_attention, flash_attention_dq, flash_attention_dkv]
    bwd_rows = phase_flash_bwd()
    phase_ldm_grad(flash_counters)
    train_launches = phase_train_ldm(flash_counters)
    import os
    import shutil

    flagship_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "output", "chip_smoke_flagship")
    flag_cfg, flag_ckpt, fit_launches, dataset = phase_train(counters,
                                                             flagship_dir)
    gen_launches, gen_images = phase_generate(counters, flag_cfg, flag_ckpt,
                                              flagship_dir, dataset)
    phase_eval(gen_images, dataset, flagship_dir)
    shutil.rmtree(flagship_dir, ignore_errors=True)  # multi-GB checkpoints

    def entry(name, key, launched, replaces):
        sites = rows[key]
        return {
            "name": name, "route": "cuda",
            "source": f"diffusionmodel_tpu_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": launched,
            "max_abs_err": max(s["max_abs_err"] for s in sites),
            "ms": sum(s["ms"] for s in sites),
            "plain_ms": sum(s["plain_ms"] for s in sites),
            "bound_ms": sum(s["bound_ms"] for s in sites),
            "bound_by": "bytes" if all(s["bound_by"] == "bytes"
                                       for s in sites) else "operations",
            "library_ms": None,
            "device_ms": sum(sum(s["device_ms"].values()) for s in sites),
            "per": f"one batch-{BATCH} forward ({len(sites)} sites)",
        }

    def flash_entry(sites, launched):
        main_site = sites[FLASH_SITES.index(FLASH_MAIN)]
        per = FLASH_PER_FORWARD
        return {
            "name": "flash_attn", "route": "cuda",
            "source": "diffusionmodel_tpu_torch/kernels/csrc/flash_attn.cu",
            "replaces": "diffusionmodel_tpu/kernels/flash_attn.py:128",
            "launches": launched,
            "max_abs_err": max(max(s["max_abs_err"], s["max_abs_err_lse"])
                               for s in sites),
            "ms": per * main_site["ms"],
            "plain_ms": per * main_site["plain_ms"],
            "bound_ms": per * main_site["bound_ms"],
            "bound_by": main_site["bound_by"],
            "bound_ms_fp32": per * main_site["bound_ms_fp32"],
            "library_ms": per * main_site["library_ms"],
            "per": f"one batch-4 SD UNet forward at 512 px ({per} sites of "
                   f"(B, N, M, H, D) = {list(FLASH_MAIN)}); bound_ms is "
                   "3xTF32 on the tensor cores (what the kernel runs), "
                   "bound_ms_fp32 the fp32 CUDA-core bound",
        }

    def bwd_entry(name, key, launched, replaces):
        main_site = bwd_rows[0]
        per = FLASH_PER_FORWARD
        return {
            "name": name, "route": "cuda",
            "source": "diffusionmodel_tpu_torch/kernels/csrc/"
                      "flash_attn_bwd.cu",
            "replaces": replaces, "launches": launched,
            "max_abs_err": max(s["max_abs_err"][g] for s in bwd_rows
                               for g in (("dq",) if key == "dq"
                                         else ("dk", "dv"))),
            "ms": per * main_site[f"ms_{key}"],
            "plain_ms": per * main_site[f"plain_ms_{key}"],
            "bound_ms": per * main_site[f"bound_ms_{key}"],
            "bound_by": main_site[f"bound_by_{key}"],
            "bound_ms_fp32": per * main_site[f"bound_ms_{key}_fp32"],
            "library_ms": per * main_site["library_ms_backward"],
            "per": f"one SD UNet training step at 512 px, batch 2 ({per} "
                   f"sites of (B, N, M, H, D) = {list(FLASH_TRAIN)}); "
                   "bound_ms is 3xTF32 on the tensor cores (what the kernel "
                   "runs), bound_ms_fp32 the fp32 CUDA-core bound; "
                   "library_ms is the whole SDPA backward (dq, dk and dv)",
        }

    fwd = flash_entry(flash_rows, flash_launches)
    fwd["train_launches"] = train_launches[0]
    se = entry("se_block", "se_block", launches[0],
               "diffusionmodel_tpu/kernels/se_block.py:202")
    ca = entry("coord_attn", "coord_attn", launches[1],
               "diffusionmodel_tpu/kernels/coord_attn.py:296")
    for row, i in ((se, 0), (ca, 1)):
        row["train_launches"] = fit_launches[i]
        row["generate_launches"] = gen_launches[i]
    print(json.dumps({"kernels": [
        se,
        ca,
        fwd,
        bwd_entry("flash_attn_dq", "dq", train_launches[1],
                  "diffusionmodel_tpu/kernels/flash_attn.py:268"),
        bwd_entry("flash_attn_dkv", "dkv", train_launches[2],
                  "diffusionmodel_tpu/kernels/flash_attn.py:285"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
