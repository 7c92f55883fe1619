#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main paths at full width, with weights drawn from
fixed torch seeds (the flagship's editing, ``.pt`` checkpoints, the side
families and the CLIP text encoder in the last phases, below): the ContextUnet serving path of ``preset("full")``
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
            for SE (weights as ``SEBlock`` passes them) the kernel timed
            over rotating copies of x of >= 200 MB, the CUDA kernels one
            call launches (must be its 1: no weight copy), the launch
            plan's design bound and bytes of x re-read, the shares of both
            bounds, and ncu's ``dram__bytes_read.sum`` where ncu runs (else
            null); for CoordAttn also the profiler's device ms per pass and
            their sum, the kernels launched per call (must be its 3), and
            the shares of the bound and of the floor of a design that reads
            x twice.
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
            cached (must be the kernel's 3), and of one eval SEBlock call
            (must be the kernel's 1).
6. serve    the ContextUnet main path, with every launch count zeroed just
            before it and PyTorch's TF32 defaults restored for the service
            (its worker must turn TF32 off itself: a forward pre-hook
            records the flags every denoiser forward sees, and the phase
            fails unless both are off): ``SamplerService`` with DDIM-5
            (``SERVE_DDIM_STEPS``: cut from DDIM-50 to 10, the DPM++-20
            service moved to serve_bf16, to make room for the editing and
            side-family phases, then to 5 for the model axis; mixed classes, two guidance scales, a
            pinned request alone and then batched with others, which must
            give the same images bit for bit, and one HTTP round trip),
            then the ancestral sampler over the last 10 steps. Every image
            must be finite and of the right shape.
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
            remat, bf16 Adam moment, fp32) for 1 epoch on 25 in-memory
            synthetic crack images (5 classes; 20 train, 5 val), with
            validation and DPM++-10 sampling of 2 images (a CFG batch of
            4, the micro-batch's shape: 5 images paid a cuDNN search of
            their own) every epoch: finite losses,
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
            this run collects 2), with the seconds the scoring took.
13. generate ``gen_samples`` on the final checkpoint: 5 classes x 1
            sample, guide scales 2.0 and 4.0 in one sweep batch, DPM++-20
            (after an untimed one-step call that autotunes its shapes)
            (finite [5, 256, 256, 3] per scale, grids written, 5 / 4
            launches per forward, each scale scored against 4 dataset
            images into quality_metrics.json); the checkpoint's EMA
            weights in a kernel model and a plain one, eval forwards at
            batches 4, 20, 4 (validation and fit's in-loop CFG batch, the
            sweep's CFG batch; the kernel model's back to back on one
            stream), each
            within relative L2 1e-4 of the plain path; then ``python -m
            diffusionmodel_tpu_torch.cli --mode generate`` (DPM++-10, one
            guide scale) in a subprocess on the same checkpoint in bf16
            with the fused head, as the README runs the flagship (its wall
            time includes the process start, the checkpoint load and
            cuDNN's search, ~5x cheaper in bf16 than in fp32); seconds and
            images/s of both.
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

The flagship as the README runs it, in bfloat16 (``model.dtype=
bfloat16``; parameters, optimizer state and checkpoints float32), in four
more phases:

kernels_bf16 (after kernels)  the bf16 forms of the SE and CoordAttn
            kernels at every flagship site at batch 16 against their bf16
            twins: relative L2 <= 4e-3 and max |diff| <= 2**-7 of max |y|;
            kernel and twin ms, the bytes bound and its share (SE as in
            ``kernels``, and no byte of x re-read); float16 and C % 8 != 0
            refused.
group_norm (after kernels_bf16)  the GroupNorm + activation kernel at
            each of the 13 (H, C, activation) sites of a bf16 flagship
            sampling forward (36 calls) at batch 16 against its twin: the
            normalised output within one bf16 ulp (2**-16 near 0) and
            identical on >= 99% of elements, the activation bit for bit the
            twin's bf16 activation of it; kernel ms over rotating copies of
            x of >= 200 MB, twin ms, the bound of x read once and out
            written once at 3.35 TB/s and the kernel's share of it; the
            per-forward sums weight each site by its calls.
forward_bf16 (after serve)  one set of weights at fp32 and bf16, fused
            upsample off and on, batch 16: forward ms, 5 SE / 4 CoordAttn
            launches per forward (and 36 GroupNorm + activation launches
            in bf16, none in fp32), bf16-vs-fp32 and fused-vs-unfused
            relative L2 (fused at fp32 <= 1e-5), each bf16 output unmoved
            when the batch is rolled.
serve_bf16 (after forward_bf16)  ``SamplerService`` DDIM-5 at max_batch 8
            in bf16, under PyTorch's TF32 defaults as in serve: the first
            request (cuDNN's search included) and a batch of three, the
            pinned request bit-identical; then a DPM++-20 service
            (``--sampler dpmpp``), a pinned request alone and batched with
            another, bit-identical; every forward of both with TF32 off,
            finite images, images/s, launches per forward (SE, CoordAttn
            and GroupNorm + activation, zeroed before).
train_bf16 (last)  ``trainer.fit`` with the README's training settings
            (bf16, fused upsample) and the train phase's others, one
            epoch: finite losses, launches per forward by mode, fp32
            parameters, EMA and checkpoint, the checkpoint reloaded
            bit-identically; one more step, profiled: steady seconds per
            step, idle share, peak GiB, and the first step's search (the
            epoch's time less two steady steps).
parallel (after train_bf16)  the data-parallel path (``parallel``) at
            world size 1 over NCCL in this process, on the flagship as
            train_bf16 runs it: two train steps through
            ``make_train_step(mesh=)`` with ``train.zero1`` against the
            same two without a mesh (loss and largest parameter
            difference within twice the plain steps' own repeat
            difference). At one data rank ZeRO-1 partitions no leaf
            (``zero1_partitioned_leaves`` 0): the step's collectives are
            the flat ``all_reduce`` alone, so ``reduce_scatter_tensor``
            and ``all_gather_into_tensor`` are run once on their own, as
            a round trip that must return its input. Then
            ``make_sampler(mesh=)`` at DDIM-10 on 8 slots bit-identical to
            the plain sampler, with its SE and CoordAttn launches (the
            bf16 entries' ``parallel_launches``); then
            ``SamplerService(mesh=)`` and the service without a mesh
            (DDIM-10, max_batch 4): a pinned request alone and batched
            behind another, bit-identical in each; the mesh service's
            (cuDNN's heuristics, as every mesh worker runs) bit-identical
            to the DDIM sampler it calls on the heuristics in a fresh
            thread; its largest difference from the autotuned service
            without a mesh, reported; the NCCL version and the world
            size. No second card exists here:
            agreement across ranks is the CPU tests' (gloo) and the
            spatial phase's.
spatial_kernels (after kernels_bf16)  the slab forms of SE and CoordAttn
            (the spatially sharded forward's kernels, ROADMAP A12b) at
            every flagship site, fp32 and bf16, split into 2 and 4
            H-slabs: each slab's statistics pooled, combined in process as
            the collective would (SE's sums added; CoordAttn's row means
            stacked and column sums added, one bottleneck on the whole
            map), each slab gated and scaled; against the twin and the
            whole-map kernel (fp32 max |diff| <= 1e-4, bf16 as
            kernels_bf16), the ms of one process's share (its slab, back
            to back), its twin's, the whole-map kernel's and the share's
            bytes bound.
spatial (after parallel)  first a probe: two processes on the one card
            over gloo each ``all_reduce`` and ``broadcast`` a CUDA
            tensor (in the ranks below, before their work) (NCCL refuses two ranks on one device; the phase
            stops there, saying so, where gloo refuses CUDA tensors).
            Then two processes (data 1 x spatial 2) drive the spatial
            main path at full width (``use_pallas``, cuDNN's heuristics:
            no per-process search): ``make_sampler(mesh=)`` with DDIM-2
            on 2 slots in fp32 and in bf16, and one fp32 train step (1 x
            2 at 256 px, no remat: the CPU tests run fit's remat on
            slabs) through ``make_train_step(mesh=)``, each process on
            H-slabs; the same two processes then run model_axis (below);
            then (``mesh_reference``, after the ranks: the memory this
            process caches for its run stays reserved) the same calls in
            this process. The ranks must agree bit for bit,
            the fp32 images lie within relative L2 1e-3 of one process's,
            the loss within 1e-4 relative, the parameters within 1% of
            the update's norm (over 2^20 sampled elements), and each
            forward calls each SE slab stage (pool, apply) 5 times and
            each CoordAttn slab stage (pool, mix, apply) 4 times, each
            stage counted where it launches, and no whole-map kernel
            (the slab entries' ``launches`` and ``stage_launches``). It proves
            correctness only: two processes on one card say nothing of
            speed.
model_axis (in spatial's two processes, after its run)  a data 1 x
            model 2 mesh (ROADMAP A12c: each wide layer's output channels
            split between the two, ``parallel.tensor``) drives the same
            calls as spatial (``make_sampler(mesh=)`` DDIM-2 on 2
            slots in fp32 and bf16, one fp32 train step) on the whole
            maps, held (``mesh_reference``) to the one-process run the
            spatial phase is held to (the same seeds and config, no
            hooks): the ranks agree bit for bit, the fp32 images within
            relative L2 1e-3, the loss within 1e-4 relative, the
            parameters (gathered) within 1% of the update's norm; each
            rank holds half the rows of every leaf ``param_shardings``
            plans and reports its parameter bytes against one process's
            and the MB its gathers all_reduce per forward; each forward
            calls the whole-map SE and CoordAttn kernels 5 and 4 times (on
            gathered weights) and no slab stage (the kernel entries'
            ``model_axis_launches``). Correctness only, as spatial.

The flagship's editing, ``.pt`` checkpoints, the side families and CLIP:

edit (after eval)  ``sample.edit_samples`` on the trained fp32 checkpoint
            at full width: img2img and inpaint of a 256 px crack image
            written as PNG (strength 0.75 of DDIM-20: 15 forwards, guide
            2.0, batch 2, the start noise pinned): finite [2, 256, 256, 3]
            images, 5 SE and 4 CoordAttn launches per forward (counts
            zeroed just before each edit), the inpaint's kept half equal to
            the source bit for bit before saving, each edit against the
            plain path (``use_pallas=False``, the same weights and noise,
            relative L2 <= 1e-4), and the img2img edit of a plain path
            whose SE gates are planted 1% too large, which must read above
            that tolerance; seconds per edit call and images/s; then
            ``cli --mode inpaint --family main`` in a subprocess.
pt_checkpoint  the trained weights written with ``torch.save`` in the
            reference's layout (``nn_model.`` keys and the DDPM schedule
            buffers), read by ``load_checkpoint(path, arch, norm)``: the
            eval forward bit-identical to the pickle's.
edit_bf16 (after train_bf16)  the edit phase on the bf16 checkpoint (bf16
            compute, fused head): launches, finite images, the kept half.
side_families  the ``mnist`` (28 px, n_feat 128, BatchNorm), ``custom``
            (CBAM, 128 px, n_feat 128) and ``labml`` (the labml U-Net at
            64 px, 64 channels, ch_mults 1-2-2-4, attention at 16 and 8
            px) presets at their own widths: one ``fit`` epoch of one or
            two steps on a synthetic dataset (finite losses, step seconds,
            peak GiB), the checkpoint reloaded into a fresh model (the
            same weights, and under cuDNN's deterministic algorithms the
            same output bit for bit), a ``gen_samples`` call (DDIM-50 for
            mnist and custom; the textbook sampler, cut to 100 steps,
            for 4 slots for labml), mnist's ancestral ``return_history`` written as a
            GIF, a pinned labml ``SamplerService`` request alone and then
            batched with another, bit-identical; mnist again at
            bf16, and custom's float32 checkpoint sampled and reloaded at
            bf16 (no second fit).
clip        only where transformers is installed: a tiny random-config
            ``CLIPTextModel`` with a minimal vocab on the card through
            ``CLIPTextEmbedder`` (against the same model on the CPU,
            relative L2 <= 1e-4), conditioning one ``LdmRunner(arch=
            "tiny")`` txt2img.

Each phase's seconds are printed as a ``{"phase": "seconds"}`` line. The
kernels line lists the bf16 forms of SE and CoordAttn as two more
entries (``se_block_bf16``, ``coord_attn_bf16``) with their launches on
the bf16 serving path, and for each form its launches in the edits.

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
# the serve phases' DDIM depth: 10 steps (50 until the edit, .pt and side
# family phases needed the time; each DDIM-50 batch of 8 took ~30 s). For
# the same reason the DPM++-20 service runs in serve_bf16 (its worker's
# bf16 search takes seconds), no longer in serve (~65 s at fp32, most of it
# that worker's own cuDNN search).
SERVE_DDIM_STEPS = 5
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
# (H, C, activation, calls) of each GroupNorm site in one bf16 sampling
# forward (36 calls, 8 groups each): the stem, the down stages' compress,
# downsample-conv and ResConvBlock norms, up0, the up stages' ResConvBlocks
# and the head.
GN_SITES = [(256, 192, "gelu", 9), (256, 192, "relu", 1), (256, 48, "gelu", 1),
            (128, 48, "gelu", 1), (128, 384, "gelu", 3), (64, 96, "gelu", 1),
            (64, 768, "gelu", 3), (32, 192, "gelu", 1),
            (32, 1536, "gelu", 3), (16, 1536, "relu", 1),
            (32, 768, "gelu", 4), (64, 384, "gelu", 4),
            (128, 192, "gelu", 4)]
CA_SITES = [(128, 192), (64, 384), (32, 768), (16, 1536)]
CA_KERNELS_PER_CALL = 3  # ca_pool, ca_bottleneck, ca_apply
SE_KERNELS_PER_CALL = 1  # se_fused: one cooperative launch
ROTATE_BYTES = 200e6  # x copies cycled through when a kernel is timed


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
            fn = re.search(r"((?:se|ca|gn)_[a-z_]+)(?:I(f|13__nv_bfloat16)?"
                           r"(?:Li(\d+)E)?E)?(?=E)", chunk)
            flash = re.search(_FLASH_MANGLED, chunk)
            used = re.search(r"Used (\d+) registers", chunk)
            spill = re.search(r"(\d+) bytes spill stores", chunk)
            if flash and used:
                regs[_flash_name(flash)] = int(used.group(1))
                spills[_flash_name(flash)] = int(spill.group(1)) if spill else 0
            elif fn and used:  # e.g. ca_pool<bf16, 4>, se_apply<fp32>, gn_act<1>
                args = [{"f": "fp32"}.get(fn.group(2), "bf16")] \
                    if fn.group(2) else []
                args += [fn.group(3)] if fn.group(3) else []
                name = fn.group(1) + (f"<{', '.join(args)}>" if args else "")
                regs[name] = int(used.group(1))
                spills[name] = int(spill.group(1)) if spill else 0
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


def se_site_weights(i: int, c: int):
    """w1 [C, R] and w2 [R, C] of SE site ``i`` (random from fixed seeds),
    as ``SEBlock`` hands them to the kernel: transposed views of
    ``nn.Linear`` weights, which the kernel reads without a copy."""
    r = c // 16
    g = torch.Generator(device="cuda").manual_seed(100 + i)
    w1 = torch.randn((c, r), generator=g, device="cuda") / c ** 0.5
    w2 = torch.randn((r, c), generator=g, device="cuda") / r ** 0.5
    return w1.t().contiguous().t(), w2.t().contiguous().t()


def rotating_ms(fn, x, iters: int) -> tuple:
    """Mean CUDA-event ms of ``fn(a)`` over ``iters`` calls that cycle
    through copies of x totalling at least ``ROTATE_BYTES`` (so no call
    finds its x in the 50 MB L2 from the call before), and the copies."""
    n = max(1, -(-int(ROTATE_BYTES) // (x.numel() * x.element_size())))
    xs = [x] + [x.clone() for _ in range(n - 1)]
    for a in xs:
        fn(a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(xs[i % n])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, n


def se_site_row(x, w1, w2, iters: int = 20) -> dict:
    """The SE kernel at one site against its twin: max |diff| (and, for
    bf16, relative L2 and max |y|), kernel ms over rotating copies of x,
    twin ms, the profiler's device ms, the bytes bound (x read once, out
    written once, the weights once; the operations at the fp32 rate) and
    the design's bound from the launch plan (x re-read where a sample does
    not fit on chip), with the shares of both. The kernels one call
    launches come from ``fresh_kernel_counts``."""
    from diffusionmodel_tpu_torch.kernels.se_block import (
        launch_plan,
        se_block,
        se_block_plain,
    )

    b, h, w, c = x.shape
    r = w1.shape[1]
    y, want = se_block(x, w1, w2).float(), se_block_plain(x, w1, w2).float()
    row = dict(shape=list(x.shape), dtype=str(x.dtype).split(".")[-1],
               max_abs_err=(y - want).abs().max().item(),
               max_abs_out=want.abs().max().item(),
               rel_l2=((y - want).norm() / want.norm()).item())
    del y, want
    ms, copies = rotating_ms(lambda a: se_block(a, w1, w2), x, iters)
    b_ms, b_by = bound(2 * x.numel() * x.element_size() + 2 * c * r * 4,
                       3 * x.numel() + 4 * b * c * r)
    plan = launch_plan(b, h, w, c, r, x.dtype)
    d_ms = (plan.bytes_read + plan.bytes_reread + plan.bytes_written) \
        / HBM_BYTES_PER_S * 1e3
    row.update(ms=ms, copies=copies,
               plain_ms=cuda_ms(lambda: se_block_plain(x, w1, w2), 10),
               device_ms=device_times(lambda: se_block(x, w1, w2)),
               bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / ms,
               design_bound_ms=d_ms, design_bound_share=d_ms / ms,
               bytes_reread=plan.bytes_reread, parts=plan.parts,
               tiles_per_part=plan.tiles_per_part)
    return row


def check_se_row(row: dict) -> None:
    check(row["kernels_per_call"] == SE_KERNELS_PER_CALL,
          f"se_block {row['shape']}: {row['kernels_per_call']} kernels per "
          f"call, the design launches {SE_KERNELS_PER_CALL}")
    check(row["dtype"] == "float32" or row["bytes_reread"] == 0,
          f"se_block bf16 {row['shape']}: the plan re-reads "
          f"{row['bytes_reread']} bytes of x")


def count_kernels_per_call() -> dict:
    """The CUDA kernels one call launches (torch.profiler): the SE kernel
    at every SE site in fp32 and bf16 (all kernels: no weight copy), the
    CoordAttn kernel at every CoordAttn site under both norm kinds and in
    bf16 (its ``ca_`` kernels), one eval CoordAttn module call with its
    packed weights cached and one eval SEBlock call (all kernels). Run by
    ``fresh_kernel_counts`` in a process of its own."""
    from diffusionmodel_tpu_torch.kernels.coord_attn import coord_attn
    from diffusionmodel_tpu_torch.kernels.se_block import se_block
    from diffusionmodel_tpu_torch.nn.blocks import SEBlock
    from diffusionmodel_tpu_torch.nn.coord_attn import CoordAttn

    out = {}
    with torch.no_grad():
        for i, (h, c) in enumerate(SE_SITES):
            w1, w2 = se_site_weights(i, c)
            for dtype in ("float32", "bfloat16"):
                x = _site_x(BATCH, h, c, i).to(getattr(torch, dtype))
                out[f"se {dtype} {h} {c}"] = sum(kernel_launches(
                    lambda: se_block(x, w1, w2)).values())
        for kind, dtype in (("group", "float32"), ("affine", "float32"),
                            ("group", "bfloat16")):
            for i, (h, c) in enumerate(CA_SITES):
                wts, groups = ca_site_weights(i, c, kind)
                x = _site_x(BATCH, h, c, 10 + i).to(getattr(torch, dtype))
                out[f"ca {kind} {dtype} {h} {c}"] = sum(
                    n for k, n in kernel_launches(
                        lambda: coord_attn(x, wts, kind, groups)).items()
                    if k.startswith("ca_"))
        torch.manual_seed(0)
        ca = CoordAttn(192, 16, norm="group").cuda().eval()
        ca.use_pallas = True
        x = torch.randn((BATCH, 192, 128, 128), device="cuda").contiguous(
            memory_format=torch.channels_last)
        out["ca module"] = sum(kernel_launches(lambda: ca(x)).values())
        se = SEBlock(192, 16, use_pallas=True).cuda().eval()
        x = torch.randn((BATCH, 192, 64, 64), device="cuda").contiguous(
            memory_format=torch.channels_last)
        out["se module"] = sum(kernel_launches(lambda: se(x)).values())
    return out


def fresh_kernel_counts() -> dict:
    """``count_kernels_per_call`` in a process of its own, before any load:
    on the card, torch.profiler drops device events once a process has
    kept it busy for ~15-30 s (seen with plain matrix products alone, no
    kernel of the port), so counts taken late in this run would read
    short."""
    import os

    code = ("import json, chip_smoke as cs\n"
            "print('COUNTS ' + json.dumps(cs.count_kernels_per_call()))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("COUNTS ")]
    check(proc.returncode == 0 and len(lines) == 1,
          f"kernel counts: rc {proc.returncode}\n{proc.stderr[-3000:]}")
    counts = json.loads(lines[0][len("COUNTS "):])
    emit("kernel_counts", **counts)
    return counts


def se_dram_bytes(dtype: str) -> list:
    """``dram__bytes_read.sum`` of one SE call at each site, from ``ncu``
    in a subprocess, where ``ncu`` is installed and works; else None per
    site (not measured)."""
    import os
    import shutil

    none = [None] * len(SE_SITES)
    if shutil.which("ncu") is None:
        return none
    code = ("import torch, chip_smoke as cs\n"
            "from diffusionmodel_tpu_torch.kernels.se_block import se_block\n"
            "for i, (h, c) in enumerate(cs.SE_SITES):\n"
            f"    x = cs._site_x(cs.BATCH, h, c, i).to(torch.{dtype})\n"
            "    se_block(x, *cs.se_site_weights(i, c))\n"
            "torch.cuda.synchronize()\n")
    try:
        out = subprocess.run(
            ["ncu", "--kernel-name", "regex:se_fused", "--metrics",
             "dram__bytes_read.sum", "--csv", sys.executable, "-c", code],
            capture_output=True, text=True, timeout=180,
            cwd=os.path.dirname(os.path.abspath(__file__))).stdout
    except (OSError, subprocess.SubprocessError):
        return none
    vals = []
    for line in out.splitlines():
        if "dram__bytes_read.sum" in line:
            cells = [v.strip('"') for v in line.split('","')]
            try:
                unit, val = cells[-2], float(cells[-1].replace(",", ""))
            except (IndexError, ValueError):
                continue
            vals.append(val * {"byte": 1, "Kbyte": 1e3, "Mbyte": 1e6,
                               "Gbyte": 1e9}.get(unit, 1))
    return vals if len(vals) == len(SE_SITES) else none


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


def ca_timing(x, wts, kind: str, groups: int, iters: int = 20) -> dict:
    """The CoordAttn kernel at one site: its CUDA-event ms over rotating
    copies of x, the bytes bound (x read once,
    out written once, the weights once; the operations at the fp32 rate)
    and the three launches' floor (x read twice and written once, at the
    HBM rate), with the shares of both."""
    from diffusionmodel_tpu_torch.kernels.coord_attn import coord_attn

    b, h, _, c = x.shape
    r = wts.w1h.shape[-1]
    wbytes = sum(getattr(wts, f.name).numel() * 4
                 for f in dataclasses.fields(wts))
    mlp = b * 2 * h * (2 * c * r + 2 * r * r + 2 * r * c)
    b_ms, b_by = bound(2 * x.numel() * x.element_size() + wbytes,
                       4 * x.numel() + mlp)
    with torch.no_grad():
        ms, copies = rotating_ms(lambda a: coord_attn(a, wts, kind, groups),
                                 x, iters)
    d_ms = 3 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
    return dict(shape=list(x.shape), dtype=str(x.dtype).split(".")[-1],
                ms=ms, copies=copies,
                timed_over=f">= {ROTATE_BYTES / 1e6:.0f} MB of rotating "
                           "copies of x",
                bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / ms,
                design_bound_ms=d_ms, design_bound_share=d_ms / ms)


def ca_site_row(x, wts, kind: str, groups: int, iters: int = 20) -> dict:
    """The CoordAttn kernel at one site against its twin: max |diff| (and
    relative L2 and max |y|, which the bf16 check reads), ``ca_timing``
    (the design's bound: x read twice and written once, the floor of the
    three launches), the twin's ms, the profiler's device ms per kernel and
    the host's ms per call (the wrapper's enqueue; where it nears ``ms`` the
    host sets the pace). The kernels one call launches come from
    ``fresh_kernel_counts``."""
    from diffusionmodel_tpu_torch.kernels.coord_attn import (
        coord_attn,
        coord_attn_plain,
    )

    def call():
        return coord_attn(x, wts, kind, groups)

    with torch.no_grad():
        y = call().float()
        want = coord_attn_plain(x, wts, kind, groups).float()
        row = dict(norm_kind=kind, max_abs_err=(y - want).abs().max().item(),
                   max_abs_out=want.abs().max().item(),
                   rel_l2=((y - want).norm() / want.norm()).item())
        del y, want
        row.update(ca_timing(x, wts, kind, groups, iters))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            call()
        row["host_ms"] = (time.perf_counter() - t0) * 1e3 / iters
        torch.cuda.synchronize()
        row["plain_ms"] = cuda_ms(
            lambda: coord_attn_plain(x, wts, kind, groups), 10)
        row["device_ms"] = {k: v for k, v in device_times(call).items()
                            if k.startswith("ca_")}
    return row


def check_ca_row(row: dict) -> None:
    if row["dtype"] == "float32":
        check(row["max_abs_err"] <= KERNEL_ATOL,
              f"coord_attn {row['norm_kind']} {row['shape']}: "
              f"|diff| {row['max_abs_err']}")
    else:
        _check_bf16_row("coord_attn", row)
    check(row["kernels_per_call"] == CA_KERNELS_PER_CALL,
          f"coord_attn {row['shape']}: {row['kernels_per_call']} kernels "
          f"per call, the design launches {CA_KERNELS_PER_CALL}")


def phase_kernels(counts: dict) -> list:
    rows = {"se_block": [], "coord_attn": [], "coord_attn_affine": []}
    with torch.no_grad():
        dram = se_dram_bytes("float32")
        for i, (h, c) in enumerate(SE_SITES):
            x = _site_x(BATCH, h, c, i)
            row = se_site_row(x, *se_site_weights(i, c))
            row["dram_bytes_read"] = dram[i]
            row["kernels_per_call"] = counts[f"se float32 {h} {c}"]
            rows["se_block"].append(row)
            emit("kernels", kernel="se_block", **row)
            check(row["max_abs_err"] <= KERNEL_ATOL,
                  f"se_block {x.shape}: |diff| {row['max_abs_err']}")
            check_se_row(row)
            del x
            torch.cuda.empty_cache()

        for kind, key in (("group", "coord_attn"),
                          ("affine", "coord_attn_affine")):
            for i, (h, c) in enumerate(CA_SITES):
                wts, groups = ca_site_weights(i, c, kind)
                x = _site_x(BATCH, h, c, 10 + i)
                rows[key].append(ca_site_row(x, wts, kind, groups))
                rows[key][-1]["kernels_per_call"] = counts[
                    f"ca {kind} float32 {h} {c}"]
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


def phase_forward(counters, counts: dict):
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
    # every device kernel of one eval CoordAttn module call, its packed
    # weights cached (the kernel's three passes, no packing), and of one
    # eval SEBlock call (the kernel alone, no weight copy)
    ca_module_kernels = counts["ca module"]
    se_module_kernels = counts["se module"]
    total = sum(by_kernel.values())
    ours = sum(v for k, v in by_kernel.items() if k[:3] in ("se_", "ca_"))
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    emit("forward", device_ms=total, se_ca_device_ms=ours,
         top_kernels=[[k, v] for k, v in top])
    emit("forward", params=n_params, shape=list(got.shape),
         se_launches=launched[0], ca_launches=launched[1],
         ca_module_kernels=ca_module_kernels,
         se_module_kernels=se_module_kernels, rel_l2=rel,
         max_abs_err=(got - want).abs().max().item(),
         max_abs_out=want.abs().max().item(), ms=times)
    check(n_params > 300e6, f"flagship has {n_params} parameters")
    check(tuple(got.shape) == (BATCH, 256, 256, 3)
          and bool(torch.isfinite(got).all()), "forward output")
    check(launched == [5, 4], f"launches per forward {launched}")
    check(ca_module_kernels == CA_KERNELS_PER_CALL,
          f"device kernels per eval CoordAttn call {ca_module_kernels}")
    check(se_module_kernels == SE_KERNELS_PER_CALL,
          f"device kernels per eval SEBlock call {se_module_kernels}")
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

    cfg = cfg.replace(sample=dataclasses.replace(
        cfg.sample, ddim_steps=SERVE_DDIM_STEPS))
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
    forwards = 3 * cfg.sample.ddim_steps + 10
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
# one epoch: the whole run must fit its time limit on a slower host too
FLAGSHIP_EPOCHS = 1
SE_PER_FORWARD, CA_PER_FORWARD = len(SE_SITES), len(CA_SITES)
GN_PER_FORWARD = sum(calls for *_, calls in GN_SITES)  # bf16 inference


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

    # two in-loop samples: their CFG batch of 4 is the micro-batch's, whose
    # convolutions the first step's cuDNN search has timed (5 samples, a
    # CFG batch of 10, paid a search of their own: ~31 s on an H100)
    return preset("full", **{
        "model.use_pallas": True, "train.ema_decay": 0.9995,
        "train.eval_sample_count": 2,
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
    # validation images (fid_proxy from 10 of them; this run collects 2)
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


GENERATE_BATCHES = (4, 20, 4)  # validation and in-loop CFG, sweep CFG


def _generation_batches_match(cfg, ckpt) -> dict:
    """The checkpoint's EMA weights (what ``gen_samples`` samples with) in
    a kernel model and a plain one: eval forwards at the batches the
    generation paths give the kernels (the sweep's CFG batch of 20, fit's
    in-loop CFG batch and validation batch of 4), the kernel model's
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
    # one guide scale (a CFG batch of 10; two until the edit and side-family
    # phases needed the time), in bf16 as the README runs the flagship: the
    # subprocess's cuDNN search is most of it, and the fp32 one took ~45 s
    # more (the in-process sweep above is fp32)
    cmd = [_sys.executable, "-m", "diffusionmodel_tpu_torch.cli", "--mode",
           "generate", "--ckpt", ckpt, "--sampler", "dpmpp", "--steps", "10",
           "--samples", "1", "--guide_scales", "2.0", "--no_eval",
           "--device", "cuda", "-o", "model.use_pallas=true",
           "-o", "model.dtype=bfloat16", "-o", "model.fused_upsample=true",
           "-o", f"sample.sample_dir={cli_dir}"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    cli_s = time.perf_counter() - t0
    made = sorted(os.listdir(os.path.join(cli_dir, os.listdir(cli_dir)[0]))) \
        if proc.returncode == 0 and os.path.isdir(cli_dir) else []
    emit("generate", run="cli", returncode=proc.returncode, seconds=cli_s,
         images_per_s=FLAGSHIP_CLASSES / cli_s, files=made,
         stderr_tail=proc.stderr[-2000:])
    check(proc.returncode == 0 and len(made) == FLAGSHIP_CLASSES + 1,
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

BF16_REL_L2 = 4e-3  # a bf16 kernel against its bf16 twin: relative L2
# ... and max |diff| over max |y|: about one bf16 ulp at the top of the
# range (a value rounded the other way where a float32 sum or gate lands
# on the other side of a rounding boundary)
BF16_MAX_REL = 2.0 ** -7
FUSED_RTOL_F32 = 1e-5  # fused vs unfused upsample head at fp32 (rel L2)


def _check_bf16_row(name: str, row: dict) -> None:
    check(row["rel_l2"] <= BF16_REL_L2
          and row["max_abs_err"] <= BF16_MAX_REL * row["max_abs_out"],
          f"{name} bf16 {row['shape']}: relative L2 {row['rel_l2']}, max "
          f"|diff| {row['max_abs_err']} of max |y| {row['max_abs_out']}")


def phase_kernels_bf16(counts: dict) -> dict:
    """The bf16 forms of the SE and CoordAttn kernels at every site of a
    batch-16 flagship forward (bf16 x, fp32 weights drawn as in
    ``phase_kernels``) against their bf16 twins."""
    from diffusionmodel_tpu_torch.kernels.coord_attn import coord_attn
    from diffusionmodel_tpu_torch.kernels.se_block import se_block

    rows = {"se_block": [], "coord_attn": []}
    with torch.no_grad():
        dram = se_dram_bytes("bfloat16")
        for i, (h, c) in enumerate(SE_SITES):
            x = _site_x(BATCH, h, c, i).bfloat16()
            row = se_site_row(x, *se_site_weights(i, c))
            row["dram_bytes_read"] = dram[i]
            row["kernels_per_call"] = counts[f"se bfloat16 {h} {c}"]
            rows["se_block"].append(row)
            emit("kernels_bf16", kernel="se_block", **row)
            _check_bf16_row("se_block", row)
            check_se_row(row)
            del x
            torch.cuda.empty_cache()
        for i, (h, c) in enumerate(CA_SITES):
            wts, groups = ca_site_weights(i, c, "group")
            x = _site_x(BATCH, h, c, 10 + i).bfloat16()
            row = ca_site_row(x, wts, "group", groups)
            row["kernels_per_call"] = counts[f"ca group bfloat16 {h} {c}"]
            rows["coord_attn"].append(row)
            emit("kernels_bf16", kernel="coord_attn", **row)
            check_ca_row(row)
            del x
            torch.cuda.empty_cache()
        # a float16 x is refused, as is a bf16 x the 16-byte loads cannot
        # take (C % 8 != 0)
        wts, groups = ca_site_weights(0, 192, "group")
        g = torch.Generator(device="cuda").manual_seed(7)
        w1 = torch.randn((192, 12), generator=g, device="cuda")
        w2 = torch.randn((12, 192), generator=g, device="cuda")
        x = _site_x(2, 16, 192, 0)
        refused = []
        for fn in (lambda a: se_block(a, w1[:a.shape[-1]], w2[:, :a.shape[-1]]),
                   lambda a: coord_attn(a, wts, "group", groups)):
            for bad, exc in ((x.half(), TypeError),
                             (x.bfloat16()[..., :188].contiguous(),
                              ValueError)):
                try:
                    fn(bad)
                except exc:
                    refused.append(True)
                    continue
                refused.append(False)
        check(refused == [True] * 4, f"float16 / C % 8 refusals {refused}")
    return rows


def _bf16_ulps(got, want) -> torch.Tensor:
    """|got - want| in bf16 ulps (bit patterns in the order of values)."""
    def ordered(t):
        bits = t.contiguous().view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits & 0x7FFF)
    return (ordered(got) - ordered(want)).abs()


def gn_site_row(h: int, c: int, act: str, iters: int = 20) -> dict:
    """The GroupNorm + activation kernel at one site at batch 16 (bf16 x
    with a mean and a scale per channel, a random affine, 8 groups)
    against its twin: the normalised output's largest ulp difference (and
    how many differ by more than one ulp and more than 2**-16), the share
    of identical outputs, whether the activation is the twin's bf16
    activation of the kernel's normalised output bit for bit; the kernel's
    ms over rotating copies of x, the twin's ms, the bound of x read once
    and out written once, and the kernel's share of it."""
    from diffusionmodel_tpu_torch.kernels.group_norm import (
        activation,
        group_norm_act,
        group_norm_act_plain,
        launch_plan,
    )

    g = torch.Generator(device="cuda").manual_seed(h + c)
    scale = 0.5 + 1.5 * torch.rand(c, generator=g, device="cuda")
    shift = 2 * torch.rand(c, generator=g, device="cuda") - 1
    x = (torch.randn((BATCH, h, h, c), generator=g, device="cuda") * scale
         + shift).bfloat16()
    w = 1 + 0.2 * torch.randn(c, generator=g, device="cuda")
    b = 0.2 * torch.randn(c, generator=g, device="cuda")
    y = group_norm_act(x, w, b, 8)
    want = group_norm_act_plain(x, w, b, 8)
    ulps = _bf16_ulps(y, want)
    far = (ulps > 1) & ((y.float() - want.float()).abs() > 2.0 ** -16)
    got = group_norm_act(x, w, b, 8, 1e-5, act)
    row = dict(shape=list(x.shape), act=act, max_ulps=int(ulps.max()),
               over_one_ulp=int(far.sum()),
               same_share=(got == group_norm_act_plain(
                   x, w, b, 8, 1e-5, act)).float().mean().item(),
               act_exact=bool(torch.equal(got, activation(y, act))),
               rerun_identical=bool(torch.equal(
                   group_norm_act(x, w, b, 8, 1e-5, act), got)))
    del y, want, ulps, far, got
    ms, copies = rotating_ms(lambda a: group_norm_act(a, w, b, 8, 1e-5, act),
                             x, iters)
    nbytes = 2 * x.numel() * x.element_size()
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    plan = launch_plan(*x.shape, 8)
    row.update(ms=ms, copies=copies, bound_ms=b_ms, bound_share=b_ms / ms,
               plain_ms=cuda_ms(lambda: group_norm_act_plain(
                   x, w, b, 8, 1e-5, act), 5),
               parts=plan.parts, part_pixels=plan.part_pixels,
               threads=plan.threads)
    return row


def phase_group_norm() -> dict:
    """The GroupNorm + activation kernel at every GroupNorm site of a bf16
    flagship sampling forward at batch 16 (``GN_SITES``) against its twin,
    and the per-forward sums (each site times its calls)."""
    rows = []
    with torch.no_grad():
        for h, c, act, calls in GN_SITES:
            row = gn_site_row(h, c, act)
            row["calls"] = calls
            rows.append(row)
            emit("group_norm", **row)
            check(row["over_one_ulp"] == 0 and row["same_share"] >= 0.99
                  and row["act_exact"] and row["rerun_identical"],
                  f"group_norm {row['shape']} {act}: {row}")
            torch.cuda.empty_cache()
    total = {k: sum(r[k] * r["calls"] for r in rows)
             for k in ("ms", "bound_ms", "plain_ms")}
    emit("group_norm", per_forward=total, calls=sum(r["calls"] for r in rows),
         bound_share=total["bound_ms"] / total["ms"])
    return {"rows": rows, **total}


def _flagship_bf16_cfg(**over):
    from diffusionmodel_tpu_torch.config import preset

    return preset("full", **{"model.use_pallas": True,
                             "model.dtype": "bfloat16", **over})


def phase_forward_bf16(counters) -> None:
    """``preset("full")`` at full width and depth with ``use_pallas``, one
    set of weights (torch seed 0, as ``phase_forward``) at fp32 and at
    bf16, fused upsample off and on, batch 16: forward ms (host clock
    around a synchronised call, best of 3 after a first one), SE,
    CoordAttn and GroupNorm + activation launches per forward (``counters``
    in that order: 5, 4, and 36 in bf16 or none in fp32), the relative L2
    of bf16 against fp32 and of fused against unfused (fp32 within 1e-5;
    bf16 printed), and each bf16 output unmoved when the batch is rolled
    by 3 slots."""
    from diffusionmodel_tpu_torch.nn import build_model

    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((BATCH, 256, 256, 3), generator=g, device="cuda")
    c = torch.arange(BATCH, device="cuda") % 5
    t = torch.rand(BATCH, generator=g, device="cuda")
    ctx = (torch.arange(BATCH, device="cuda") >= BATCH // 2).float()
    sd, outs, rows = None, {}, {}
    for dt in ("float32", "bfloat16"):
        for fused in (False, True):
            cfg = _flagship_bf16_cfg(**{"model.dtype": dt,
                                        "model.fused_upsample": fused})
            torch.manual_seed(0)
            m = build_model(cfg.model, cfg.diffusion.high_thresh,
                            device="cuda")
            if sd is None:
                sd = {k: v.clone() for k, v in m.state_dict().items()}
            m.load_state_dict(sd)
            with torch.no_grad():
                before = _counts(counters)
                t0 = time.perf_counter()
                y = m(x, c, t, ctx)
                torch.cuda.synchronize()
                first_ms = (time.perf_counter() - t0) * 1e3
                launched = [b - a for a, b in zip(before, _counts(counters))]
                times = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    m(x, c, t, ctx)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
            key = f"{dt}{'_fused' if fused else ''}"
            outs[key] = y.float()
            if dt == "bfloat16":  # a sample's output whatever its slot
                perm = torch.roll(torch.arange(BATCH, device="cuda"), 3)
                with torch.no_grad():
                    moved = m(x[perm], c[perm], t[perm], ctx[perm])
                check(torch.equal(moved[torch.argsort(perm)], y),
                      f"{key}: outputs move with their batch position")
            rows[key] = dict(out_dtype=str(y.dtype), first_ms=first_ms,
                             ms=min(times), launches=launched)
            check(bool(torch.isfinite(y.float()).all())
                  and tuple(y.shape) == (BATCH, 256, 256, 3),
                  f"{key} forward output")
            check(launched == [SE_PER_FORWARD, CA_PER_FORWARD,
                               GN_PER_FORWARD if dt == "bfloat16" else 0],
                  f"{key}: launches per forward {launched}")
            check(y.dtype == (torch.bfloat16 if dt == "bfloat16"
                              else torch.float32), f"{key}: {y.dtype}")
            del m, y
            torch.cuda.empty_cache()
    rel = {"bf16_vs_fp32": _rel_l2(outs["bfloat16"], outs["float32"]),
           "bf16_fused_vs_fp32_fused": _rel_l2(outs["bfloat16_fused"],
                                               outs["float32_fused"]),
           "fused_vs_unfused_fp32": _rel_l2(outs["float32_fused"],
                                            outs["float32"]),
           "fused_vs_unfused_bf16": _rel_l2(outs["bfloat16_fused"],
                                            outs["bfloat16"])}
    emit("forward_bf16", batch=BATCH, forwards=rows, rel_l2=rel,
         speedup_bf16=rows["float32"]["ms"] / rows["bfloat16"]["ms"],
         speedup_bf16_fused=rows["float32"]["ms"]
         / rows["bfloat16_fused"]["ms"])
    check(rel["fused_vs_unfused_fp32"] <= FUSED_RTOL_F32,
          f"fused vs unfused at fp32: {rel['fused_vs_unfused_fp32']}")


def phase_serve_bf16(counters, env) -> list:
    """The README's serve command in bf16 (``-o model.dtype=bfloat16``,
    with ``use_pallas``): ``SamplerService`` DDIM-5 (``SERVE_DDIM_STEPS``,
    50 until the edit and side-family phases) at max_batch 8, the
    launch counts zeroed just before and PyTorch's TF32 defaults restored
    (the worker turns TF32 off itself; the denoiser's bf16 convolutions
    are unaffected): a pinned request alone (the service's first batch,
    cuDNN's search included), then batched with two others (one batch),
    bit-identical; then a DPM++-20 service (``--sampler dpmpp``), a pinned
    request alone and batched with another, bit-identical; every
    denoiser forward of both services seen with TF32 off; latencies and
    images/s; the SE, CoordAttn and GroupNorm + activation launches
    (``counters`` in that order), one set a forward."""
    from diffusionmodel_tpu_torch.diffusion import Schedule
    from diffusionmodel_tpu_torch.nn import build_model
    from diffusionmodel_tpu_torch.serving import SamplerService

    cfg = _flagship_bf16_cfg(**{"sample.ddim_steps": SERVE_DDIM_STEPS})
    dpm_steps = cfg.sample.dpm_steps
    dc = cfg.diffusion
    torch.manual_seed(0)
    model = build_model(cfg.model, dc.high_thresh, device="cuda")
    sched = Schedule.create(dc.beta1, dc.beta2, dc.n_T, "cuda")
    for f in counters:
        f.launches = 0
    t_serve = time.perf_counter()
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
        st = dict(svc.stats)
    # the DPM++ kind (``--mode serve --sampler dpmpp``): its own service,
    # a pinned request alone (its first batch, cuDNN's search included),
    # then batched with another request
    with SamplerService(model, cfg, sched, max_batch=8, sampler="dpmpp",
                        service_seed=0) as svc:
        t0 = time.perf_counter()
        dpm_alone = svc.generate([0, 1, 2, 3, 4], guide_w=3.0, seed=7)
        dpm_alone_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        futs = [svc.submit([1, 2, 3], guide_w=2.0),
                svc.submit([0, 1, 2, 3, 4], guide_w=3.0, seed=7)]
        dpm_outs = [f.result(timeout=900) for f in futs]
        dpm_batched_s = time.perf_counter() - t0
        dpm_st = dict(svc.stats)
    flags.stop()
    torch.cuda.synchronize()
    launches = _counts(counters)
    forwards = 2 * cfg.sample.ddim_steps + 2 * dpm_steps
    pin_err = float(np.abs(outs[1] - alone).max())
    dpm_pin_err = float(np.abs(dpm_outs[1] - dpm_alone).max())
    emit("serve_bf16", sampler="dpmpp", steps=dpm_steps, max_batch=8,
         pinned_alone_vs_batched_max_abs=dpm_pin_err,
         first_request_s=dpm_alone_s, batched_s=dpm_batched_s,
         images_per_s=dpm_st["slots_used"] / dpm_st["busy_seconds"],
         stats=dpm_st)
    emit("serve_bf16", sampler="ddim", steps=cfg.sample.ddim_steps,
         max_batch=8, dtype=cfg.model.dtype,
         pinned_alone_vs_batched_max_abs=pin_err, batched_runs=batched_runs,
         first_request_s=alone_s, batched_s=batched_s,
         images_per_s=st["slots_used"] / st["busy_seconds"],
         batched_images_per_s=8 / batched_s, stats=st,
         seconds=time.perf_counter() - t_serve, forwards=forwards,
         se_launches=launches[0], ca_launches=launches[1],
         gn_launches=launches[2], precision=flags.summary())
    flags.check("serve_bf16")
    check(_finite(alone, 3) and all(_finite(o, len(o)) for o in outs),
          "bf16 DDIM images finite, [n,256,256,3]")
    check(batched_runs == 1, f"three requests took {batched_runs} batches")
    check(pin_err == 0.0, f"bf16: pinned request moved by {pin_err}")
    check(_finite(dpm_alone, 5) and all(_finite(o, len(o)) for o in dpm_outs),
          "bf16 DPM++ images finite, [n,256,256,3]")
    check(dpm_st["batches"] == 2,
          f"two DPM++ requests took {dpm_st['batches'] - 1} batches")
    check(dpm_pin_err == 0.0,
          f"bf16 DPM++: pinned request moved by {dpm_pin_err}")
    check(launches == [SE_PER_FORWARD * forwards, CA_PER_FORWARD * forwards,
                       GN_PER_FORWARD * forwards],
          f"bf16 serving launches {launches} for {forwards} forwards")
    del model
    torch.cuda.empty_cache()
    return launches


def phase_train_bf16(counters, out_dir, dataset) -> list:
    """``trainer.fit`` with the README's model settings
    (``model.dtype=bfloat16``, ``model.fused_upsample=True``) and the fp32
    ``train`` phase's others (4 x 4 micro-batches, full remat, bf16 Adam
    moment, the same 25 synthetic images), one epoch: finite losses,
    launches per forward by mode, parameters and the checkpoint in fp32,
    the reloaded checkpoint bit-identical; then one more step, profiled:
    steady seconds per step, idle share, peak GiB. The first step's
    search is the epoch's time less two steady steps."""
    import json
    import os

    from diffusionmodel_tpu_torch.checkpoint import (
        extract_params,
        load_checkpoint,
    )
    from diffusionmodel_tpu_torch.compat.flax_bridge import (
        state_dict_from_flax,
    )
    from diffusionmodel_tpu_torch.data import BatchLoader
    from diffusionmodel_tpu_torch.device_check import fp32_compute
    from diffusionmodel_tpu_torch.diffusion import Schedule
    from diffusionmodel_tpu_torch.nn import build_model
    from diffusionmodel_tpu_torch.train import build_optimizer, make_train_step
    from diffusionmodel_tpu_torch.trainer import fit

    base = _flagship_train_cfg(out_dir)
    cfg = base.replace(
        model=dataclasses.replace(base.model, dtype="bfloat16",
                                  fused_upsample=True),
        train=dataclasses.replace(base.train, n_epoch=1))
    tc, dc = cfg.train, cfg.diffusion
    watch = _ForwardLaunches(counters)
    torch.cuda.reset_peak_memory_stats()
    for f in counters:
        f.launches = 0
    t0 = time.perf_counter()
    state = fit(cfg, dataset=dataset, verbose=False, device="cuda")
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_steps = state.step
    launches = _counts(counters)
    watch.close()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    run = f"{out_dir}/run"
    log = json.load(open(os.path.join(run, "metrics", "metrics_ep0.json")))
    seen = watch.summary()
    check(all(np.isfinite(log["train_loss"] + log["val_loss"])),
          f"bf16 finite losses {log}")
    check(fit_steps == 2, f"bf16: {fit_steps} optimizer steps")
    check(state.model.dtype == torch.bfloat16
          and all(p.dtype == torch.float32 for p in state.params)
          and all(p.dtype == torch.float32 for p in state.ema.parameters()),
          "bf16 compute on fp32 parameters and EMA")
    check(seen["eval"]["launches_per_forward"] == [(SE_PER_FORWARD,
                                                    CA_PER_FORWARD)]
          and seen["train"]["launches_per_forward"] == [(0, 0)]
          and launches == [SE_PER_FORWARD * seen["eval"]["forwards"],
                           CA_PER_FORWARD * seen["eval"]["forwards"]],
          f"bf16 train launches {launches}, {seen}")
    ck = load_checkpoint(os.path.join(run, "ckpt_ep0"))
    dtypes = {str(np.asarray(a).dtype) for tree in (ck["params"],
                                                    ck["ema_params"])
              for a in _leaves(tree)}
    kept = _flagship_eval_forward(state.model)
    torch.manual_seed(1)
    fresh = build_model(cfg.model, dc.high_thresh, device="cuda")
    fresh.load_state_dict(state_dict_from_flax(extract_params(
        ck, prefer_ema=False), ck["batch_stats"]))
    same = torch.equal(_flagship_eval_forward(fresh), kept)
    del fresh, ck
    check(dtypes == {"float32"}, f"bf16 checkpoint arrays {dtypes}")
    check(same, "bf16: the reloaded checkpoint gives another output")

    step = make_train_step(state.model, Schedule.create(
        dc.beta1, dc.beta2, dc.n_T, "cuda"), cfg, build_optimizer(cfg, 2))
    loader = BatchLoader(dataset, np.arange(len(dataset)), tc.batch_size,
                         tc.accum_steps, seed=2, num_workers=0)
    one = next(iter(loader))
    gen = torch.Generator(device="cuda").manual_seed(3)
    with fp32_compute(torch.device("cuda")):
        torch.cuda.reset_peak_memory_stats()
        by_kernel, busy_ms, wall_ms = kernel_breakdown(
            lambda: step(state, one, gen))
        steady_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    per_step = wall_ms / 1e3
    epoch_steps_s = fit_steps / log["steps_per_sec"][-1]
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    emit("train_bf16", dtype=cfg.model.dtype,
         fused_upsample=cfg.model.fused_upsample, images=len(dataset),
         epochs=1, steps=fit_steps, batch=[tc.accum_steps, tc.batch_size],
         remat=tc.remat_policy, moment_dtype=tc.moment_dtype,
         train_loss=log["train_loss"], val_loss=log["val_loss"],
         fit_s=fit_s, fit_peak_mem_gib=peak,
         epoch_seconds_per_step=1.0 / log["steps_per_sec"][-1],
         steady_seconds_per_step=per_step,
         images_per_s=tc.batch_size * tc.accum_steps / per_step,
         first_step_search_s=epoch_steps_s - 2 * per_step,
         idle_share=1.0 - busy_ms / wall_ms, steady_peak_mem_gib=steady_peak,
         device_ms=sum(by_kernel.values()),
         top_kernels=[[k, v] for k, v in top], se_launches=launches[0],
         ca_launches=launches[1], forwards=seen,
         checkpoint_dtypes=sorted(dtypes), checkpoint_bit_identical=same,
         img_metrics=log["img_metrics"])
    del step, state
    torch.cuda.empty_cache()
    return launches


PARALLEL_SLOTS, PARALLEL_DDIM = 8, 10  # the mesh sampler's batch and depth


def _flat_params(model) -> torch.Tensor:
    """Every parameter, flattened in order; whole where the model holds
    blocks over 'model' (a collective then)."""
    from diffusionmodel_tpu_torch.parallel.tensor import full_state_dict

    sd = full_state_dict(model)
    return torch.cat([sd[n].detach().flatten()
                      for n, _ in model.named_parameters()])


def phase_parallel(counters, out_dir, dataset) -> list:
    """The data-parallel path (``parallel``) at world size 1 over NCCL, in
    this process (a ``FileStore`` group of one rank), on the flagship at
    full width as the README trains it (bf16, fused head,
    ``use_pallas``): two train steps of ``fit``'s micro-batch shape (4 x 4
    at 256 px) through ``make_train_step(mesh=)`` with ``train.zero1``
    (which partitions no leaf at one data rank, so the step's one
    collective is the flat ``all_reduce``; ``reduce_scatter`` and
    ``all_gather`` run in the CPU tests' gloo groups) against the same two
    steps without a mesh, from one copy of the
    weights and one set of draws; the plain steps run twice first, and
    their difference is the noise floor that the mesh steps' loss and
    largest parameter difference must stay within twice of (cuDNN's
    weight-gradient sums are not bit-reproducible). Then
    ``make_sampler(mesh=)`` at DDIM-10 on 8 slots against the same sampler
    without a mesh: bit for bit, with 5 SE and 4 CoordAttn launches per
    forward counted in the mesh run alone. Then the services with and
    without the mesh (``_pinned_service``), the mesh's held to the sampler
    on the same cuDNN algorithms (``_pinned_reference``). Returns the
    mesh sampler's launches."""
    import os

    import torch.distributed as dist

    from diffusionmodel_tpu_torch.data import BatchLoader
    from diffusionmodel_tpu_torch.device_check import fp32_compute
    from diffusionmodel_tpu_torch.diffusion import Schedule
    from diffusionmodel_tpu_torch.nn import build_model
    from diffusionmodel_tpu_torch.parallel import make_mesh
    from diffusionmodel_tpu_torch.train import (
        create_train_state,
        make_train_step,
    )
    from diffusionmodel_tpu_torch.trainer import make_sampler

    base = _flagship_train_cfg(out_dir)
    cfg = base.replace(
        model=dataclasses.replace(base.model, dtype="bfloat16",
                                  fused_upsample=True),
        train=dataclasses.replace(base.train, zero1=True),
        sample=dataclasses.replace(base.sample, sampler="ddim",
                                   ddim_steps=PARALLEL_DDIM))
    tc, dc = cfg.train, cfg.diffusion
    dev = torch.device("cuda")
    os.makedirs(out_dir, exist_ok=True)
    torch.cuda.set_device(0)  # the rank's card, before NCCL starts
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(out_dir, "store"), 1),
        rank=0, world_size=1)
    try:
        mesh = make_mesh(tc.mesh_data, tc.mesh_model, tc.mesh_spatial)
        check(mesh.distributed and mesh.shape == {"data": 1, "model": 1,
                                                  "spatial": 1},
              f"mesh {mesh}")
        torch.manual_seed(0)
        model = build_model(cfg.model, dc.high_thresh, device=dev)
        start = {k: v.clone() for k, v in model.state_dict().items()}
        sched = Schedule.create(dc.beta1, dc.beta2, dc.n_T, dev)
        loader = BatchLoader(dataset, np.arange(len(dataset)),
                             tc.batch_size, tc.accum_steps, seed=2,
                             num_workers=0, mesh=mesh)
        batches = list(loader)[:2]

        partitioned = []

        def two_steps(on_mesh):
            model.load_state_dict(start)
            m = mesh if on_mesh else None
            state, opt = create_train_state(model, cfg, 2, mesh=m)
            if on_mesh:  # ZeRO-1 partitions nothing at one data rank
                partitioned.append(sum(
                    not sh.is_replicated
                    for sh in state.opt_state.shardings or ()))
            step = make_train_step(model, sched, cfg, opt, mesh=m)
            gen = torch.Generator(device=dev).manual_seed(5)
            losses, secs = [], []
            for b in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(float(step(state, b, gen)))
                secs.append(time.perf_counter() - t0)
            del state, step
            return losses, _flat_params(model), secs

        with fp32_compute(dev):
            plain, plain_p, plain_s = two_steps(False)
            again, again_p, _ = two_steps(False)
            meshed, mesh_p, mesh_s = two_steps(True)
            floor_loss = max(abs(a - b) for a, b in zip(plain, again))
            floor_param = (plain_p - again_p).abs().max().item()
            mesh_loss = max(abs(a - b) for a, b in zip(plain, meshed))
            mesh_param = (plain_p - mesh_p).abs().max().item()
            del plain_p, again_p, mesh_p
            torch.cuda.empty_cache()

            classes = torch.arange(PARALLEL_SLOTS, device=dev) \
                % cfg.model.n_classes
            model.load_state_dict(start)
            del start
            want = make_sampler(cfg, sched, PARALLEL_SLOTS, classes=classes)(
                model, torch.Generator(device=dev).manual_seed(11), 2.0)
            fan_out = make_sampler(cfg, sched, PARALLEL_SLOTS,
                                   classes=classes, mesh=mesh)
            for f in counters:
                f.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = fan_out(model, torch.Generator(device=dev).manual_seed(11),
                          2.0)
            torch.cuda.synchronize()
            sample_s = time.perf_counter() - t0
            launches = _counts(counters)
            # ZeRO-1's two other collectives, by the names train.py calls,
            # on this PyTorch over NCCL (identities at one rank)
            probe = torch.randn(1 << 20, device=dev)
            scattered, gathered = torch.empty_like(probe), \
                torch.empty_like(probe)
            dist.reduce_scatter_tensor(scattered, probe)
            dist.all_gather_into_tensor(gathered, scattered)
            collectives_ok = torch.equal(gathered, probe)
        # the service's fan-out (broadcast of each batch, at one rank the
        # whole batch in this process) against the sampler it calls, both
        # on cuDNN's heuristics (as a mesh's workers run), and beside the
        # service without a mesh (autotuned: other algorithms may sum in
        # other orders)
        t0 = time.perf_counter()
        plain_svc = _pinned_service(model, cfg, sched, None)
        mesh_svc = _pinned_service(model, cfg, sched, mesh)
        service_s = time.perf_counter() - t0
        service_want = _pinned_reference(model, cfg, sched)
        nccl = ".".join(str(v) for v in torch.cuda.nccl.version())
        world = dist.get_world_size()
    finally:
        dist.destroy_process_group()
    same = torch.equal(got, want)
    emit("parallel", backend="nccl", nccl=nccl, world_size=world,
         mesh=mesh.shape, dtype=cfg.model.dtype, zero1=tc.zero1,
         zero1_partitioned_leaves=partitioned[0],
         reduce_scatter_all_gather_identity=collectives_ok,
         batch=[tc.accum_steps, tc.batch_size], steps=len(batches),
         plain_losses=plain, plain_repeat_losses=again, mesh_losses=meshed,
         floor_loss=floor_loss, floor_param_max_abs=floor_param,
         mesh_loss_diff=mesh_loss, mesh_param_max_abs=mesh_param,
         plain_step_s=plain_s, mesh_step_s=mesh_s,
         sampler=f"ddim-{PARALLEL_DDIM}", slots=PARALLEL_SLOTS,
         sampler_bit_identical=same, sample_s=sample_s,
         se_launches=launches[0], ca_launches=launches[1],
         finite=bool(torch.isfinite(got).all()),
         service_pinned_alone_batched_equal=[
             bool(np.array_equal(*plain_svc)), bool(np.array_equal(
                 *mesh_svc))],
         service_mesh_equals_sampler=bool(np.array_equal(service_want,
                                                         mesh_svc[0])),
         service_mesh_vs_plain_service_max_abs=float(np.abs(
             plain_svc[0] - mesh_svc[0]).max()),
         service_s=service_s)
    check(len(batches) == 2, f"{len(batches)} batches")
    check(all(np.isfinite(plain + again + meshed)), "finite losses")
    check(mesh_loss <= 2 * floor_loss and mesh_param <= 2 * floor_param,
          f"mesh step off the plain one: loss {mesh_loss} (floor "
          f"{floor_loss}), params {mesh_param} (floor {floor_param})")
    check(same, "the mesh sampler's images differ from the plain one's")
    check(collectives_ok, "reduce_scatter_tensor / all_gather_into_tensor "
          "over one NCCL rank changed the tensor")
    check(np.array_equal(*plain_svc) and np.array_equal(*mesh_svc)
          and np.array_equal(service_want, mesh_svc[0]),
          "SamplerService(mesh=): a pinned request's images differ alone, "
          "batched or from the sampler on the same cuDNN algorithms")
    check(launches == [SE_PER_FORWARD * PARALLEL_DDIM,
                       CA_PER_FORWARD * PARALLEL_DDIM],
          f"mesh sampler launches {launches}")
    del model
    torch.cuda.empty_cache()
    return launches


# The spatially sharded forward (ROADMAP A12b): the slab forms of the SE
# and CoordAttn kernels in one process at every flagship site, split into
# SPATIAL_SHARDS slabs (the constrain rule keeps each of these sites
# sharded: at 2 and 4 slabs every slab holds >= 4 rows, and the port's
# forward runs each of these sites on slabs); then SPATIAL_RANKS processes
# on the one card over gloo (the card has one GPU and NCCL refuses two
# ranks on one device; gloo runs all_reduce and broadcast on CUDA
# tensors), which prove correctness only: two processes sharing a card
# say nothing about speed.
SPATIAL_SHARDS = (2, 4)
SPATIAL_RANKS = 2
SPATIAL_SLOTS, SPATIAL_DDIM, SPATIAL_BF16_DDIM = 2, 2, 2
# micro-batches x samples of the one step, without remat (fit's remat
# runs on slabs in the CPU tests): the time limit
SPATIAL_TRAIN_BATCH = (1, 2)
# ranks against one process, fp32 (cuDNN's heuristics in both: no
# search per process): the sampler's images by relative L2, the step's
# loss relative, its parameters within a share of the update's norm
SPATIAL_IMG_RTOL, SPATIAL_LOSS_RTOL, SPATIAL_PARAM_SHARE = 1e-3, 1e-4, 1e-2
SPATIAL_PARAM_SAMPLES = 1 << 20  # parameter elements compared, fixed seed
SPATIAL_RANK_TIMEOUT_S = 900
# each rank's share of the card's memory: two ranks and, after them, this
# process's reference share one card (cuDNN's heuristics take large
# workspaces for some fp32 shapes)
SPATIAL_RANK_MEMORY = 0.45


def _slabs(x, shards: int) -> list:
    return [t.contiguous() for t in x.split(x.shape[1] // shards, dim=1)]


def _slab_errors(y, want, whole) -> dict:
    y, want, whole = y.float(), want.float(), whole.float()
    return dict(max_abs_err=(y - want).abs().max().item(),
                max_abs_err_whole=(y - whole).abs().max().item(),
                max_abs_out=want.abs().max().item(),
                rel_l2=((y - want).norm() / want.norm()).item(),
                rel_l2_whole=((y - whole).norm() / whole.norm()).item())


def _check_slab_row(name: str, row: dict) -> None:
    if row["dtype"] == "float32":
        check(max(row["max_abs_err"], row["max_abs_err_whole"])
              <= KERNEL_ATOL, f"{name} {row['shape']} in {row['shards']} "
              f"slabs: |diff| {row['max_abs_err']} (twin), "
              f"{row['max_abs_err_whole']} (whole-map kernel)")
    else:
        for key in ("", "_whole"):
            _check_bf16_row(f"{name}{key}", dict(
                row, rel_l2=row["rel_l2" + key],
                max_abs_err=row["max_abs_err" + key]))


def se_slab_rows(dtype) -> list:
    """The SE slab form at every flagship SE site, in SPATIAL_SHARDS slabs:
    the slabs' sums added in process (as the all_reduce adds them), each
    slab gated and scaled, against the twin and the whole-map kernel;
    the ms of one process's share (its slab's pooling and gate-and-scale
    launches, back to back), its twin's, the whole-map kernel's, and the
    bytes bound of that share."""
    from diffusionmodel_tpu_torch.kernels.se_block import (
        _gate_and_scale,
        se_block,
        se_block_plain,
        se_slab_apply,
        se_slab_pool,
    )

    rows = []
    for i, (h, c) in enumerate(SE_SITES):
        x = _site_x(BATCH, h, c, i).to(dtype)
        w1, w2 = se_site_weights(i, c)
        r = w1.shape[1]
        whole, want = se_block(x, w1, w2), se_block_plain(x, w1, w2)
        whole_ms = cuda_ms(lambda: se_block(x, w1, w2), 10)
        for shards in SPATIAL_SHARDS:
            slabs = _slabs(x, shards)
            sums = se_slab_pool(slabs[0])
            for t in slabs[1:]:
                sums = sums + se_slab_pool(t)
            y = torch.cat([se_slab_apply(t, sums, w1, w2, h * h)
                           for t in slabs], dim=1)
            row = dict(kernel="se_block_slab", shape=list(x.shape),
                       dtype=str(x.dtype).split(".")[-1], shards=shards,
                       slab_rows=h // shards, **_slab_errors(y, want, whole))
            del y
            t0 = slabs[0]

            def share():
                return se_slab_apply(t0, se_slab_pool(t0), w1, w2, h * h)

            def plain_share():
                return _gate_and_scale(t0, t0.float().sum(dim=(1, 2))
                                       / (h * h), w1, w2)

            b_ms, b_by = bound(2 * t0.numel() * t0.element_size()
                               + 2 * c * r * 4, 3 * t0.numel()
                               + 4 * BATCH * c * r)
            row.update(ms=cuda_ms(share, 10), plain_ms=cuda_ms(plain_share,
                                                               10),
                       whole_ms=whole_ms, bound_ms=b_ms, bound_by=b_by,
                       timed="back to back, L2 warm")
            row["bound_share"] = b_ms / row["ms"]
            _check_slab_row("se_block_slab", row)
            emit("spatial_kernels", **row)
            rows.append(row)
            del slabs, t0
        del x, whole, want
        torch.cuda.empty_cache()
    return rows


def ca_slab_rows(dtype) -> list:
    """The CoordAttn slab form at every flagship CoordAttn site (GroupNorm,
    as the flagship runs it), in SPATIAL_SHARDS slabs: each slab pooled,
    the row means stacked and the column sums added in process (as the
    gather and the all_reduce give them), one bottleneck on the whole
    map, each slab's apply pass, against the twin and the whole-map
    kernel; the ms of one process's share (its slab's pool and apply, and
    the bottleneck), its twin's, the whole-map kernel's, and the bytes
    bound of that share."""
    from diffusionmodel_tpu_torch.kernels.coord_attn import (
        coord_attn,
        coord_attn_plain,
        coord_attn_slab_apply,
        coord_attn_slab_apply_plain,
        coord_attn_slab_mix,
        coord_attn_slab_mix_plain,
        coord_attn_slab_pool,
        coord_attn_slab_pool_plain,
    )

    rows = []
    with torch.no_grad():
        for i, (h, c) in enumerate(CA_SITES):
            wts, groups = ca_site_weights(i, c, "group")
            x = _site_x(BATCH, h, c, 10 + i).to(dtype)
            r = wts.w1h.shape[-1]
            eb = x.element_size()
            whole = coord_attn(x, wts, "group", groups)
            want = coord_attn_plain(x, wts, "group", groups)
            whole_ms = cuda_ms(lambda: coord_attn(x, wts, "group", groups),
                               10)
            wbytes = sum(getattr(wts, f.name).numel() * 4
                         for f in dataclasses.fields(wts))
            for shards in SPATIAL_SHARDS:
                slabs = _slabs(x, shards)
                pools = [coord_attn_slab_pool(t) for t in slabs]
                rmean = torch.cat([p[0] for p in pools], dim=1)
                colsum = pools[0][1]
                for p in pools[1:]:
                    colsum = colsum + p[1]
                yn, yx = coord_attn_slab_mix(rmean, colsum, wts, "group",
                                             groups)
                hs = h // shards
                y = torch.cat([coord_attn_slab_apply(t, yn, yx, wts, k * hs)
                               for k, t in enumerate(slabs)], dim=1)
                row = dict(kernel="coord_attn_slab", shape=list(x.shape),
                           dtype=str(x.dtype).split(".")[-1], shards=shards,
                           slab_rows=hs, **_slab_errors(y, want, whole))
                del y, pools
                t0 = slabs[0]

                def share():
                    coord_attn_slab_pool(t0)
                    n, m = coord_attn_slab_mix(rmean, colsum, wts, "group",
                                               groups)
                    return coord_attn_slab_apply(t0, n, m, wts, 0)

                def plain_share():
                    coord_attn_slab_pool_plain(t0)
                    n, m = coord_attn_slab_mix_plain(rmean, colsum, wts,
                                                     "group", groups)
                    return coord_attn_slab_apply_plain(t0, n, m, wts, 0)

                mlp = BATCH * 2 * h * (2 * c * r + 2 * r * r + 2 * r * c)
                b_ms, b_by = bound(2 * t0.numel() * eb + wbytes,
                                   4 * t0.numel() + mlp)
                row.update(ms=cuda_ms(share, 10),
                           plain_ms=cuda_ms(plain_share, 10),
                           whole_ms=whole_ms, bound_ms=b_ms, bound_by=b_by,
                           timed="back to back, L2 warm")
                row["bound_share"] = b_ms / row["ms"]
                _check_slab_row("coord_attn_slab", row)
                emit("spatial_kernels", **row)
                rows.append(row)
                del slabs, t0, rmean, colsum, yn, yx
            del x, whole, want
            torch.cuda.empty_cache()
    return rows


def phase_spatial_kernels() -> dict:
    """The slab forms of SE and CoordAttn, fp32 and bf16 (module
    docstring, ``spatial_kernels``): {dtype: {kernel: rows}}."""
    return {name: {"se_block_slab": se_slab_rows(dt),
                   "coord_attn_slab": ca_slab_rows(dt)}
            for name, dt in (("float32", torch.float32),
                             ("bfloat16", torch.bfloat16))}


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _start_ranks(fn: str, out_dir: str, *args) -> list:
    """``SPATIAL_RANKS`` processes running ``chip_smoke.<fn>(rank, world,
    port, out_dir, *args)`` on the one card."""
    import os

    port = _free_port()
    here = os.path.dirname(os.path.abspath(__file__))
    procs = []
    for rank in range(SPATIAL_RANKS):
        code = (f"import sys; sys.path.insert(0, {here!r}); import "
                f"chip_smoke as c; c.{fn}({rank}, {SPATIAL_RANKS}, {port}, "
                f"{out_dir!r}, *{args!r})")
        log = open(os.path.join(out_dir, f"{fn}_rank{rank}.log"), "wb")
        procs.append(subprocess.Popen([sys.executable, "-c", code], cwd=here,
                                      stdout=log, stderr=subprocess.STDOUT))
    return procs


def _wait_ranks(procs, fn: str, out_dir: str, timeout: float) -> list:
    """Each rank's exit code (None where it was killed at ``timeout``)
    and the tail of its log; every process is gone after."""
    import os

    t_end = time.monotonic() + timeout
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=max(1.0, t_end - time.monotonic())))
        except subprocess.TimeoutExpired:
            codes.append(None)
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    tails = []
    for rank in range(len(procs)):
        with open(os.path.join(out_dir, f"{fn}_rank{rank}.log"), "rb") as f:
            tails.append(f.read()[-3000:].decode(errors="replace"))
    return codes, tails


def _gloo_group(rank: int, world: int, port: int):
    import datetime

    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(minutes=10))


def gloo_cuda_probe(rank: int, world: int, out_dir: str) -> bool:
    """The probe, in a rank of the group: ``all_reduce`` and ``broadcast``
    of a CUDA tensor over gloo; writes what it got (or the error) and
    returns whether both arrived whole."""
    import os

    import torch.distributed as dist

    try:
        x = torch.full((1024,), float(rank + 1), device="cuda")
        dist.all_reduce(x)
        y = torch.full((1024,), float(rank), device="cuda")
        dist.broadcast(y, src=0)
        ok, err = bool((x == world * (world + 1) / 2).all()
                       and (y == 0).all() and x.is_cuda and y.is_cuda), None
    except Exception as e:  # the refusal is this phase's finding
        ok, err = False, f"{type(e).__name__}: {e}"
    with open(os.path.join(out_dir, f"probe{rank}.json"), "w") as f:
        json.dump({"ok": ok, "error": err}, f)
    return ok


def _spatial_cfg(dtype: str = "float32"):
    from diffusionmodel_tpu_torch.config import preset

    a, b = SPATIAL_TRAIN_BATCH
    return preset("full", **{
        "model.use_pallas": True, "model.dtype": dtype,
        "model.fused_upsample": dtype == "bfloat16",
        "sample.sampler": "ddim", "train.accum_steps": a,
        "train.batch_size": b, "train.remat": False,
        "train.mesh_spatial": SPATIAL_RANKS})


def _spatial_batch():
    """One fixed wire batch [A, B] of the flagship's size."""
    rng = np.random.default_rng(41)
    a, b = SPATIAL_TRAIN_BATCH
    return {"x": rng.integers(0, 256, (a, b, 256, 256, 3), dtype=np.uint8),
            "c": rng.integers(0, FLAGSHIP_CLASSES, (a, b)).astype(np.int32),
            "mask": rng.integers(0, 3, (a, b, 256, 256), dtype=np.uint8)}


# the counted wrappers of the spatial path: each slab stage, then the
# whole-map kernels (which the path on slabs must not call), and the calls
# of each in one forward on slabs
SPATIAL_COUNTERS = ("se_slab_pool", "se_slab_apply", "coord_attn_slab_pool",
                    "coord_attn_slab_mix", "coord_attn_slab_apply",
                    "se_block", "coord_attn")
SPATIAL_PER_FORWARD = (SE_PER_FORWARD, SE_PER_FORWARD, CA_PER_FORWARD,
                       CA_PER_FORWARD, CA_PER_FORWARD, 0, 0)


def _spatial_counters() -> list:
    import diffusionmodel_tpu_torch.kernels.coord_attn as ca
    import diffusionmodel_tpu_torch.kernels.se_block as se

    return [getattr(ca if n.startswith("coord") else se, n)
            for n in SPATIAL_COUNTERS]


def spatial_runs(mesh=None) -> dict:
    """The spatial main path at full width (``mesh`` with a 'spatial'
    axis: the model with the spatial hooks, on H-slabs), the model-axis
    path (``mesh`` with a 'model' axis: ``make_sampler`` cuts the model to
    this process's blocks), or (``mesh`` None) the same calls in one
    process: a DDIM sampler (``make_sampler``, fp32 and bf16,
    ``use_pallas``) and one fp32 train step (``make_train_step``) from
    weights of torch seed 0, under cuDNN's heuristics.
    The calls of each slab stage and of the whole-map kernels in the
    sampler calls (``SPATIAL_COUNTERS``, zeroed just before each), the
    fp32 model's parameter bytes in this process, and on a 'model' axis
    whether each leaf ``param_shardings`` plans holds half its rows."""
    import dataclasses as dc_

    from diffusionmodel_tpu_torch.device_check import fp32_compute
    from diffusionmodel_tpu_torch.diffusion import Schedule
    from diffusionmodel_tpu_torch.nn import build_model
    from diffusionmodel_tpu_torch.parallel import (
        image_sharding,
        param_shardings,
    )
    from diffusionmodel_tpu_torch.parallel.tensor import gathered_bytes
    from diffusionmodel_tpu_torch.train import (
        create_train_state,
        make_train_step,
    )
    from diffusionmodel_tpu_torch.trainer import make_sampler

    dev = torch.device("cuda")
    counters = _spatial_counters()
    shards = (mesh.shape["spatial"] if mesh is not None
              and mesh.shape["spatial"] > 1 else 0)
    out = {"launches": {}, "sample_s": {}}
    with fp32_compute(dev, autotune=False):
        for dtype, steps in (("float32", SPATIAL_DDIM),
                             ("bfloat16", SPATIAL_BF16_DDIM)):
            cfg = _spatial_cfg(dtype)
            cfg = cfg.replace(sample=dc_.replace(cfg.sample,
                                                 ddim_steps=steps))
            dcf = cfg.diffusion
            torch.manual_seed(0)
            model = build_model(cfg.model, dcf.high_thresh,
                                spatial_shards=shards, device=dev)
            sched = Schedule.create(dcf.beta1, dcf.beta2, dcf.n_T, dev)
            classes = torch.arange(SPATIAL_SLOTS, device=dev) \
                % cfg.model.n_classes
            sampler = make_sampler(cfg, sched, SPATIAL_SLOTS,
                                   classes=classes, mesh=mesh)
            plan = {}
            if mesh is not None and mesh.shape["model"] > 1:
                plan = {n: (sh.dims[0][0], tuple(p.shape)) for (n, sh), p
                        in zip(param_shardings(mesh, model).items(),
                               model.parameters())
                        if not sh.is_replicated}
            for f in counters:
                f.launches = 0
            gathered_bytes(reset=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            imgs = sampler(model, torch.Generator(device=dev).manual_seed(
                13), 2.0)
            torch.cuda.synchronize()
            out["sample_s"][dtype] = time.perf_counter() - t0
            out.setdefault("gathered_mb", {})[dtype] = gathered_bytes() / 1e6
            if dtype == "float32":
                held = dict(model.named_parameters())
                out["param_bytes"] = sum(p.numel() * p.element_size()
                                         for p in held.values())
                out["planned"] = len(plan)
                out["halves"] = all(
                    held[n].shape[d] * 2 == shape[d] and all(
                        held[n].shape[i] == k
                        for i, k in enumerate(shape) if i != d)
                    for n, (d, shape) in plan.items())
            out["launches"][dtype] = _counts(counters)
            out[f"images_{dtype}"] = imgs.cpu()
            if dtype == "float32":
                state, opt = create_train_state(model, cfg, 1, mesh=mesh)
                step = make_train_step(model, sched, cfg, opt, mesh=mesh)
                batch = _spatial_batch()
                if mesh is not None:
                    rows = image_sharding(mesh, 5, 1, 2)
                    batch = {k: rows.local(v) if v.ndim >= 4 else v
                             for k, v in batch.items()}
                before = _flat_params(model)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out["loss"] = float(step(state, batch, torch.Generator(
                    device=dev).manual_seed(17)))
                torch.cuda.synchronize()
                out["step_s"] = time.perf_counter() - t0
                after = _flat_params(model)
                idx = torch.randint(after.numel(), (SPATIAL_PARAM_SAMPLES,),
                                    generator=torch.Generator(
                                        device=dev).manual_seed(3),
                                    device=dev)
                out["params"] = after[idx].cpu()
                out["update_norm"] = (after[idx] - before[idx]).norm().item()
                del state, step, before, after
            del model
            torch.cuda.empty_cache()
    return out


# the two rank groups' meshes, (data, model, spatial) at world size 2
MESH_RUNS = {"spatial": (1, 1, SPATIAL_RANKS),
             "model": (1, SPATIAL_RANKS, 1)}


def mesh_rank(rank: int, world: int, port: int, out_dir: str) -> None:
    """A rank of the spatial phase: the gloo probe, then (where gloo took
    the CUDA tensors) ``spatial_runs`` on each mesh of ``MESH_RUNS`` in
    turn (the spatial path on H-slabs, then the model axis), each run's
    results saved with its seconds."""
    import os

    import torch.distributed as dist

    from diffusionmodel_tpu_torch.parallel import make_mesh

    _gloo_group(rank, world, port)
    torch.cuda.set_per_process_memory_fraction(SPATIAL_RANK_MEMORY)
    try:
        if not gloo_cuda_probe(rank, world, out_dir):
            return
        for name, (d, m, sp) in MESH_RUNS.items():
            t0 = time.perf_counter()
            mesh = make_mesh(data=d, model=m, spatial=sp)
            result = spatial_runs(mesh)
            result["mesh"] = mesh.shape
            result["run_s"] = time.perf_counter() - t0
            result["jax_imported"] = "jax" in sys.modules
            torch.save(result, os.path.join(out_dir, f"{name}{rank}.pt"))
    finally:
        dist.destroy_process_group()


def phase_spatial(out_dir):
    """Two processes on the one card over gloo: the probe, then the
    spatial main path (``spatial_runs`` on a data 1 x spatial 2 mesh)
    and the model axis (the same calls on a data 1 x model 2 mesh), one
    after the other in the same two processes. Returns {run: the ranks'
    results}, or None where gloo refused CUDA tensors;
    ``phase_mesh_reference`` holds both to one process."""
    import os

    os.makedirs(out_dir, exist_ok=True)
    torch.cuda.empty_cache()
    codes, tails = _wait_ranks(_start_ranks("mesh_rank", out_dir),
                               "mesh_rank", out_dir, SPATIAL_RANK_TIMEOUT_S)
    probe = []
    for rank in range(SPATIAL_RANKS):
        path = os.path.join(out_dir, f"probe{rank}.json")
        probe.append(json.load(open(path)) if os.path.exists(path)
                     else {"ok": False, "error": "no probe result"})
    emit("spatial", probe="gloo all_reduce and broadcast of CUDA tensors",
         ok=[p["ok"] for p in probe], errors=[p["error"] for p in probe])
    if not all(p["ok"] for p in probe):
        emit("spatial", ran=False, exit_codes=codes, log_tails=tails,
             reason="gloo refused CUDA tensors on this card: the spatial "
             "and model-axis paths' on-card runs wait for two cards")
        return None
    check(codes == [0] * SPATIAL_RANKS,
          f"spatial / model-axis ranks exited {codes}: {tails}")
    return {name: [torch.load(os.path.join(out_dir, f"{name}{r}.pt"),
                              weights_only=False)
                   for r in range(SPATIAL_RANKS)] for name in MESH_RUNS}


def _compare(got: list, one: dict) -> dict:
    """The ranks' results against the one-process run: images, loss and
    sampled parameters, and whether the ranks agree."""
    r0 = got[0]
    row = {}
    for dtype in ("float32", "bfloat16"):
        a, b = r0[f"images_{dtype}"], one[f"images_{dtype}"]
        row[f"images_rel_l2_{dtype}"] = ((a - b).norm() / b.norm()).item()
        row[f"ranks_agree_{dtype}"] = all(
            torch.equal(r[f"images_{dtype}"], a) for r in got)
        row[f"finite_{dtype}"] = bool(torch.isfinite(a).all())
    row["loss"], row["one_loss"] = r0["loss"], one["loss"]
    row["loss_rel"] = abs(r0["loss"] - one["loss"]) / abs(one["loss"])
    row["ranks_agree_loss_params"] = all(
        r["loss"] == r0["loss"] and torch.equal(r["params"], r0["params"])
        for r in got)
    # over the same sampled elements
    row["param_diff_norm"] = (r0["params"] - one["params"]).norm().item()
    row["param_update_norm"] = one["update_norm"]
    row["jax_imported"] = any(r["jax_imported"] for r in got)
    return row


def _check_against_one(name: str, row: dict, launches: dict,
                       per_forward: list) -> None:
    check(not row["jax_imported"], f"a {name} rank imported jax")
    check(row["ranks_agree_loss_params"], f"{name} ranks' loss or "
          "parameters differ")
    for dtype in ("float32", "bfloat16"):
        check(row[f"ranks_agree_{dtype}"] and row[f"finite_{dtype}"],
              f"{name} {dtype} images: ranks agree "
              f"{row[f'ranks_agree_{dtype}']}, finite "
              f"{row[f'finite_{dtype}']}")
        steps = SPATIAL_DDIM if dtype == "float32" else SPATIAL_BF16_DDIM
        check(launches[dtype] == [n * steps for n in per_forward],
              f"{name} {dtype} launches {launches[dtype]} of "
              f"{SPATIAL_COUNTERS}")
    check(row["images_rel_l2_float32"] <= SPATIAL_IMG_RTOL,
          f"{name} fp32 images off one process: relative L2 "
          f"{row['images_rel_l2_float32']}")
    check(row["loss_rel"] <= SPATIAL_LOSS_RTOL,
          f"{name} step loss {row['loss']} against {row['one_loss']}")
    check(row["param_diff_norm"] <= SPATIAL_PARAM_SHARE
          * row["param_update_norm"],
          f"{name} step parameters {row['param_diff_norm']} off one "
          f"process (update norm {row['param_update_norm']}, both over "
          f"{SPATIAL_PARAM_SAMPLES} sampled elements)")


# the model-axis path runs on whole maps: the whole-map kernels only
MODEL_PER_FORWARD = (0, 0, 0, 0, 0, SE_PER_FORWARD, CA_PER_FORWARD)


def phase_mesh_reference(runs) -> tuple:
    """The spatial and model-axis paths' calls in this process
    (``spatial_runs()``, after the ranks: the memory this process's
    caching allocator holds for its run stays reserved), and each rank
    group held to it: the ranks agree bit for bit, fp32 images within
    relative L2 ``SPATIAL_IMG_RTOL``, the loss within
    ``SPATIAL_LOSS_RTOL``, the sampled parameters within
    ``SPATIAL_PARAM_SHARE`` of the update's norm, the launches per
    forward (slab stages on the spatial path, the whole-map kernels on
    the model axis, whose ranks must each hold half the rows of every
    planned leaf). Returns each group's launches per dtype ({} where the
    ranks did not run)."""
    if runs is None:
        return {}, {}
    t0 = time.perf_counter()
    one = spatial_runs()  # this process's reference, after the ranks
    one_s = time.perf_counter() - t0
    common = dict(ranks=SPATIAL_RANKS, backend="gloo",
                  cudnn="heuristics (no search: each process would pay "
                  "it)", slots=SPATIAL_SLOTS, ddim=SPATIAL_DDIM,
                  bf16_ddim=SPATIAL_BF16_DDIM,
                  batch=list(SPATIAL_TRAIN_BATCH), one_process_s=one_s,
                  one_sample_s=one["sample_s"], one_step_s=one["step_s"],
                  counted=SPATIAL_COUNTERS)

    def row_of(got):
        r0 = got[0]
        return dict(common, mesh=r0["mesh"], ranks_s=r0["run_s"],
                    rank_sample_s=r0["sample_s"], rank_step_s=r0["step_s"],
                    launches=r0["launches"], **_compare(got, one))

    got = runs["spatial"]
    row = dict(row_of(got), one_launches=one["launches"])
    emit("spatial", **row)
    _check_against_one("spatial", row, got[0]["launches"],
                       SPATIAL_PER_FORWARD)
    got = runs["model"]
    r0 = got[0]
    row = dict(row_of(got),
               gathered_mb_per_forward={
                   dt: mb / (SPATIAL_DDIM if dt == "float32"
                             else SPATIAL_BF16_DDIM)
                   for dt, mb in r0["gathered_mb"].items()},
               planned_leaves=r0["planned"],
               halves=[r["halves"] for r in got],
               rank_param_bytes=[r["param_bytes"] for r in got],
               one_param_bytes=one["param_bytes"])
    row["param_bytes_share"] = (max(row["rank_param_bytes"])
                                / one["param_bytes"])
    emit("model_axis", **row)
    check(row["planned_leaves"] > 0 and all(row["halves"]),
          f"model-axis blocks: {row['planned_leaves']} planned leaves, "
          f"half their rows held {row['halves']}")
    _check_against_one("model-axis", row, r0["launches"], MODEL_PER_FORWARD)
    return runs["spatial"][0]["launches"], r0["launches"]


SERVICE_SLOTS, SERVICE_SEED, SERVICE_GUIDE = 4, 21, 2.0  # the pinned request


def _pinned_service(model, cfg, sched, mesh) -> tuple:
    """A ``SamplerService`` (DDIM, max_batch 4) over ``mesh``: a pinned
    request's images alone (slots 0-1), then batched behind another
    request (slots 2-3)."""
    from diffusionmodel_tpu_torch.serving import SamplerService

    svc = SamplerService(model, cfg, sched, max_batch=SERVICE_SLOTS,
                         sampler="ddim", max_wait_ms=1000, service_seed=3,
                         mesh=mesh)
    try:
        alone = svc.generate([0, 1], guide_w=SERVICE_GUIDE,
                             seed=SERVICE_SEED)
        svc.submit([2, 3], guide_w=3.0, seed=4)
        return alone, svc.submit([0, 1], guide_w=SERVICE_GUIDE,
                                 seed=SERVICE_SEED).result()
    finally:
        svc.close()


def _pinned_reference(model, cfg, sched) -> np.ndarray:
    """The pinned request of ``_pinned_service`` through the DDIM sampler
    the service calls, in slots 0-1 of a batch of 4 (the start noise from
    the request's seed, as the service draws it; the other slots zeros),
    on cuDNN's heuristics in a thread of its own (cuDNN keeps a thread's
    choices, searched or not, so a fresh thread takes the heuristics'
    algorithm for every shape, as the mesh's worker does)."""
    import threading

    from diffusionmodel_tpu_torch.device_check import fp32_compute
    from diffusionmodel_tpu_torch.diffusion import sample_cfg_ddim

    mc, sc, dev = cfg.model, cfg.sample, sched.device
    shape = (mc.img_size, mc.img_size, mc.in_ch)
    x = np.zeros((SERVICE_SLOTS, *shape), np.float32)
    x[:2] = np.random.default_rng(SERVICE_SEED).standard_normal(
        (2, *shape), np.float32)
    out = {}

    def run():
        with fp32_compute(dev, autotune=False), torch.no_grad():
            out["imgs"] = sample_cfg_ddim(
                model.eval(), torch.Generator(device=dev).manual_seed(0),
                SERVICE_SLOTS, shape, mc.n_classes, sched, cfg.diffusion,
                guide_w=torch.full((SERVICE_SLOTS,), SERVICE_GUIDE,
                                   device=dev),
                n_steps=sc.ddim_steps, eta=sc.ddim_eta,
                discretize=sc.ddim_discretize,
                classes=torch.tensor([0, 1, 0, 0], device=dev),
                x_init=torch.from_numpy(x).to(dev))[:2].cpu().numpy()

    worker = threading.Thread(target=run)
    worker.start()
    worker.join()
    check("imgs" in out, "the pinned request's reference sampler failed")
    return out["imgs"]


# DDIM-20 (DDIM-50 until the spatial phases needed the time)
EDIT_STEPS, EDIT_STRENGTH, EDIT_GUIDE, EDIT_BATCH = 20, 0.75, 2.0, 2
# the planted fault that shows the kernel-vs-plain comparison can fail:
# every SE gate of the plain path 1% too large in one img2img run
EDIT_PLANTED_GATE = 1.01
# DDIM steps an edit runs: max(1, min(n, round(strength * n))) = 15
EDIT_FORWARDS = max(1, min(EDIT_STEPS, round(EDIT_STRENGTH * EDIT_STEPS)))


def _edit_source(dataset, out_dir) -> str:
    """The dataset's first crack image (256 px), written as a PNG."""
    import os

    from diffusionmodel_tpu_torch.utils.grid import save_image

    os.makedirs(out_dir, exist_ok=True)
    return save_image(dataset.load(0, augment=False)[0],
                      os.path.join(out_dir, "edit_source.png"), denorm=True)


def phase_edit(counters, cfg, ckpt, out_dir, dataset, tag="edit") -> list:
    """``sample.edit_samples`` (the ``--family main`` front door) on the
    trained flagship checkpoint at full width, img2img and inpaint
    (strength 0.75 of DDIM-20: 15 forwards, guide 2.0, batch 2, the
    default bottom-half keep-mask) from a crack image written as PNG, the
    start noise pinned: finite [2, 256, 256, 3] images, 5 SE and 4
    CoordAttn launches per forward, the inpaint's kept half equal to the
    source bit for bit before it is saved; at fp32 each edit against the
    plain path (``use_pallas=False``, the same weights and noise) by
    relative L2, and the img2img edit once more with a planted fault (the
    plain path's SE gates 1% too large) that the comparison must catch;
    seconds per edit call (sampling only) and images/s.
    Returns the launches of both edits."""
    import os

    from diffusionmodel_tpu_torch.checkpoint import (
        extract_params,
        load_checkpoint,
    )
    from diffusionmodel_tpu_torch.compat.flax_bridge import load_flax
    from diffusionmodel_tpu_torch.device_check import fp32_compute
    from diffusionmodel_tpu_torch.diffusion import Schedule, sample_cfg_edit
    from diffusionmodel_tpu_torch.nn import build_model
    from diffusionmodel_tpu_torch.sample import (
        _load_edit_image,
        _load_keep_mask,
        edit_samples,
    )

    mc, dc = cfg.model, cfg.diffusion
    src = _edit_source(dataset, out_dir)
    x0 = np.repeat(_load_edit_image(src, mc.img_size, mc.in_ch), EDIT_BATCH,
                   axis=0)
    g = torch.Generator(device="cuda").manual_seed(41)
    noise = torch.randn(x0.shape, generator=g, device="cuda")
    plain = None
    if mc.dtype == "float32":
        ck = load_checkpoint(ckpt)
        torch.manual_seed(1)
        plain = build_model(dataclasses.replace(mc, use_pallas=False),
                            dc.high_thresh, device="cuda")
        load_flax(plain, extract_params(ck), ck["batch_stats"])
        del ck
    sched = Schedule.create(dc.beta1, dc.beta2, dc.n_T, "cuda")
    total = [0, 0]
    for mode in ("img2img", "inpaint"):
        watch = _ForwardLaunches(counters)
        for f in counters:
            f.launches = 0
        t0 = time.perf_counter()
        res = edit_samples(
            cfg, ckpt, src, mode=mode, class_id=1, guide_w=EDIT_GUIDE,
            strength=EDIT_STRENGTH, n_steps=EDIT_STEPS, batch=EDIT_BATCH,
            out_dir=os.path.join(out_dir, f"{tag}_{mode}"), verbose=False,
            device="cuda", noise=noise)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        launches = _counts(counters)
        watch.close()
        seen = watch.summary()
        imgs = res["images"]
        kept = None
        if mode == "inpaint":
            keep = _load_keep_mask(None, mc.img_size) > 0
            kept = bool(np.array_equal(imgs[:, keep], x0[:, keep]))
        rel = None
        if plain is not None:
            mask = (_load_keep_mask(None, mc.img_size) if mode == "inpaint"
                    else None)
            with fp32_compute(torch.device("cuda")):
                want = sample_cfg_edit(
                    plain, None, x0, mc.n_classes, sched, dc,
                    guide_w=EDIT_GUIDE, n_steps=EDIT_STEPS,
                    strength=EDIT_STRENGTH, inpaint_mask=mask,
                    classes=torch.full((EDIT_BATCH,), 1, device="cuda"),
                    discretize=cfg.sample.ddim_discretize, noise=noise)
            rel = _rel_l2_np(imgs, want.cpu().numpy())
        planted = None
        if plain is not None and mode == "img2img":
            planted = _planted_gate_rel_l2(
                plain, imgs, x0, cfg, sched, noise)
        emit(tag, mode=mode, dtype=mc.dtype, steps=EDIT_STEPS,
             strength=EDIT_STRENGTH, forwards=seen["eval"]["forwards"],
             batch=EDIT_BATCH, seconds=res["seconds"],
             images_per_s=EDIT_BATCH / res["seconds"], call_seconds=call_s,
             se_launches=launches[0], ca_launches=launches[1],
             kernel_vs_plain_rel_l2=rel,
             planted_gate_vs_kernel_rel_l2=planted,
             kept_region_bit_identical=kept,
             files=sorted(os.listdir(res["out_dir"])))
        check(imgs.shape == (EDIT_BATCH, 256, 256, 3)
              and bool(np.isfinite(imgs).all()), f"{tag} {mode} images")
        check(seen["eval"]["forwards"] == EDIT_FORWARDS
              and launches == [SE_PER_FORWARD * EDIT_FORWARDS,
                               CA_PER_FORWARD * EDIT_FORWARDS],
              f"{tag} {mode} launches {launches}, {seen}")
        check(kept is not False, f"{tag}: the kept region moved")
        check(rel is None or rel <= FORWARD_RTOL,
              f"{tag} {mode}: kernel vs plain {rel}")
        check(planted is None or planted > FORWARD_RTOL,
              f"{tag} {mode}: a plain path with its SE gates x"
              f"{EDIT_PLANTED_GATE} passed the comparison ({planted})")
        total = [a + b for a, b in zip(total, launches)]
    del plain
    torch.cuda.empty_cache()
    return total


def _planted_gate_rel_l2(plain, imgs, x0, cfg, sched, noise) -> float:
    """The img2img edit of ``plain`` with every SE gate scaled by
    ``EDIT_PLANTED_GATE`` (a forward hook on each ``SEBlock``: its output
    is x * gate), against the kernel path's images by relative L2."""
    from diffusionmodel_tpu_torch.device_check import fp32_compute
    from diffusionmodel_tpu_torch.diffusion import sample_cfg_edit
    from diffusionmodel_tpu_torch.nn.blocks import SEBlock

    hooks = [m.register_forward_hook(
        lambda mod, args, out: out * EDIT_PLANTED_GATE)
        for m in plain.modules() if isinstance(m, SEBlock)]
    check(len(hooks) == SE_PER_FORWARD, f"{len(hooks)} SE blocks")
    try:
        with fp32_compute(torch.device("cuda")):
            got = sample_cfg_edit(
                plain, None, x0, cfg.model.n_classes, sched, cfg.diffusion,
                guide_w=EDIT_GUIDE, n_steps=EDIT_STEPS,
                strength=EDIT_STRENGTH,
                classes=torch.full((EDIT_BATCH,), 1, device="cuda"),
                discretize=cfg.sample.ddim_discretize, noise=noise)
    finally:
        for h in hooks:
            h.remove()
    return _rel_l2_np(imgs, got.cpu().numpy())


def phase_edit_cli(ckpt, out_dir, dataset) -> None:
    """``python -m diffusionmodel_tpu_torch.cli --mode inpaint --family
    main`` on the checkpoint in a subprocess, batch 1, the edit phase's
    DDIM-20 (its time includes the process start, the checkpoint load and
    cuDNN's search)."""
    import os
    import sys as _sys

    src = _edit_source(dataset, out_dir)
    cli_dir = os.path.join(out_dir, "edit_cli")
    cmd = [_sys.executable, "-m", "diffusionmodel_tpu_torch.cli", "--mode",
           "inpaint", "--family", "main", "--ckpt", ckpt, "--orig_img", src,
           "--batch_size", "1", "--steps", str(EDIT_STEPS),
           "--device", "cuda", "--out_dir", cli_dir,
           "-o", "model.use_pallas=true"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    cli_s = time.perf_counter() - t0
    made = sorted(os.listdir(cli_dir)) if os.path.isdir(cli_dir) else []
    emit("edit", run="cli", returncode=proc.returncode, seconds=cli_s,
         files=made, stdout_tail=proc.stdout[-500:],
         stderr_tail=proc.stderr[-2000:])
    check(proc.returncode == 0 and made == [
        "inpaint_grid.png", "inpaint_s0.png"],
        f"cli --mode inpaint --family main: rc {proc.returncode}, {made}")


def phase_pt_checkpoint(cfg, ckpt, out_dir) -> None:
    """The trained flagship's sampling weights written with ``torch.save``
    in the reference's layout (``{"model_state_dict": {"nn_model." + k: v}
    + the DDPM schedule buffers, "epoch"}``), read back through
    ``load_checkpoint(path, arch, norm)``: the eval forward of a model
    loaded from the ``.pt`` is bit-identical to the one from the pickle."""
    import os

    from diffusionmodel_tpu_torch.checkpoint import (
        extract_params,
        load_checkpoint,
    )
    from diffusionmodel_tpu_torch.compat.flax_bridge import (
        load_flax,
        state_dict_from_flax,
    )
    from diffusionmodel_tpu_torch.nn import build_model
    from diffusionmodel_tpu_torch.schedules import ddpm_schedules_np

    mc, dc = cfg.model, cfg.diffusion
    ck = load_checkpoint(ckpt)
    params, stats = extract_params(ck), ck["batch_stats"]
    sd = {"nn_model." + k: v for k, v in
          state_dict_from_flax(params, stats).items()}
    sd.update({k: torch.from_numpy(v) for k, v in
               ddpm_schedules_np(dc.beta1, dc.beta2, dc.n_T).items()})
    path = os.path.join(out_dir, "flagship.pt")
    t0 = time.perf_counter()
    torch.save({"model_state_dict": sd, "epoch": int(ck["epoch"])}, path)
    save_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    t0 = time.perf_counter()
    pt = load_checkpoint(path, arch=mc.arch, norm=mc.norm)
    load_s = time.perf_counter() - t0
    outs = []
    for p, st in ((params, stats), (extract_params(pt), pt["batch_stats"])):
        torch.manual_seed(1)
        model = build_model(mc, dc.high_thresh, device="cuda")
        load_flax(model, p, st)
        outs.append(_flagship_eval_forward(model))
        del model
    same = torch.equal(*outs)
    emit("pt_checkpoint", bytes=size, save_s=save_s, load_s=load_s,
         weights_only=pt["weights_only"], epoch=pt["epoch"],
         eval_output_bit_identical=same)
    os.remove(path)
    check(same, "the .pt checkpoint gives another eval output")
    check(pt["weights_only"] is True and pt["epoch"] == ck["epoch"],
          "the .pt checkpoint's reading")
    del ck, pt, sd
    torch.cuda.empty_cache()


# the side presets at their own widths; datasets, epochs and sampler depth
# cut (mnist, custom: DDIM-50 for their 400 / 500-step ancestral loop;
# labml: a 100-step textbook chain for its 1000 steps, to fit the run's
# time limit)
SIDE = {
    "mnist": {"train.n_epoch": 1, "sample.sampler": "ddim"},
    "custom": {"train.n_epoch": 1, "sample.sampler": "ddim",
               "model.n_classes": FLAGSHIP_CLASSES, "train.val_split": 0.2},
    "labml": {"train.n_epoch": 1, "diffusion.n_T": 100},
}


def _side_dataset(name, cfg):
    from diffusionmodel_tpu_torch.data import (
        MnistDataset,
        SyntheticImageDataset,
    )

    tc = cfg.train
    step = tc.batch_size * tc.accum_steps
    if name == "mnist":  # two steps of 256 after the 10% validation split
        return MnistDataset(synthetic=True, n_synthetic=int(2 * step / 0.9))
    if name == "labml":
        return SyntheticImageDataset(n=int(2 * step / 0.9), img_size=64,
                                     channels=3)
    dc = cfg.diffusion  # one step of 8 x 4 from 25 crack images
    return _synthetic_crack_dataset(
        128, (dc.low_weight, dc.mid_weight, dc.high_weight))


def _side_forward(model, cfg, seed=5):
    mc = cfg.model
    g = torch.Generator(device="cuda").manual_seed(seed)
    s = mc.img_size
    x = torch.randn((4, s, s, mc.in_ch), generator=g, device="cuda")
    c = torch.arange(4, device="cuda") % mc.n_classes
    n = cfg.diffusion.n_T
    t = (torch.tensor([1.0, n // 4, 3 * n // 5, n - 1], device="cuda")
         if cfg.diffusion.schedule_family == "textbook"
         else torch.rand(4, generator=g, device="cuda"))
    with torch.no_grad():
        return model.eval()(x, c, t, torch.ones(4, device="cuda"))


def _side_run(name, cfg, dataset, ckpt=None) -> dict:
    """One ``fit`` epoch (or, given ``ckpt``, none: that checkpoint is
    sampled in ``cfg``'s compute type), the checkpoint reloaded into a
    fresh model (the same weights and output), and a ``gen_samples``
    call."""
    import json
    import os

    from diffusionmodel_tpu_torch.checkpoint import (
        extract_params,
        load_checkpoint,
    )
    from diffusionmodel_tpu_torch.compat.flax_bridge import load_flax
    from diffusionmodel_tpu_torch.nn import build_model
    from diffusionmodel_tpu_torch.sample import gen_samples
    from diffusionmodel_tpu_torch.trainer import fit

    mc, tc = cfg.model, cfg.train

    def loaded():
        ck = load_checkpoint(ckpt)
        torch.manual_seed(1)
        m = build_model(mc, cfg.diffusion.high_thresh, device="cuda")
        load_flax(m, extract_params(ck, prefer_ema=False),
                  ck.get("batch_stats"))
        return m

    torch.cuda.reset_peak_memory_stats()
    row = dict(preset=name, arch=mc.arch, dtype=mc.dtype,
               img_size=mc.img_size, n_feat=mc.n_feat, images=len(dataset))
    if ckpt is None:
        t0 = time.perf_counter()
        state = fit(cfg, dataset=dataset, verbose=False, device="cuda")
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        model = state.model
        log = json.load(open(os.path.join(tc.save_dir, "metrics",
                                          "metrics_ep0.json")))
        ckpt = os.path.join(tc.save_dir, "ckpt_ep0")
        row.update(steps=state.step, batch=[tc.accum_steps, tc.batch_size],
            train_loss=log["train_loss"], val_loss=log["val_loss"],
            seconds_per_step=1.0 / log["steps_per_sec"][-1], fit_s=fit_s,
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        check(all(np.isfinite(log["train_loss"] + log["val_loss"])),
              f"{name}: finite losses {log}")
    else:
        model = loaded()
        row.update(fit="none: the float32 run's checkpoint")
    fresh = loaded()
    same_weights = all(torch.equal(a, b) for a, b in zip(
        model.state_dict().values(), fresh.state_dict().values()))
    # under cuDNN's deterministic algorithms: with its default choice the
    # labml net's eval output did not repeat bit for bit on the card
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic
    cudnn.deterministic = True
    try:
        same = torch.equal(_side_forward(fresh, cfg),
                           _side_forward(model, cfg))
    finally:
        cudnn.deterministic = saved
    del fresh
    n_per = 4 if name == "labml" else 1
    t0 = time.perf_counter()
    res = gen_samples(cfg, ckpt, n_samples_per_class=n_per,
                      guide_scales=[2.0], eval_quality=False,
                      dataset=dataset, verbose=False, device="cuda")
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    imgs = res[2.0]["images"]
    row.update(params=sum(p.numel() for p in model.parameters()),
               reloaded_weights_equal=same_weights,
               reloaded_bit_identical=same,
               sampler=("textbook" if name == "labml"
                        else cfg.sample.sampler),
               sample_images=len(imgs), sample_seconds=res[2.0]["seconds"],
               gen_call_seconds=gen_s)
    emit("side_families", **row)
    n_cls = mc.n_classes if name != "custom" else len(dataset.classes)
    check(same_weights and same,
          f"{name}: the reloaded checkpoint gives another output")
    check(imgs.shape == (n_per * n_cls, mc.img_size, mc.img_size, mc.in_ch)
          and bool(np.isfinite(imgs).all()), f"{name}: sampled images")
    return {"model": model, "ckpt": ckpt}


def phase_side_families(out_dir) -> None:
    """The ``mnist`` (28 px, n_feat 128, BatchNorm), ``custom`` (CBAM, 128
    px, n_feat 128) and ``labml`` (the labml U-Net at 64 px, 64 channels,
    ch_mults 1-2-2-4, attention at 16 and 8 px, the textbook schedule)
    presets at their own widths on the card: one ``fit`` epoch of one or
    two steps on a synthetic dataset (finite losses; step seconds, peak
    GiB), the checkpoint reloaded bit-identically, a ``gen_samples`` call
    (mnist and custom DDIM-50, labml the textbook sampler, 100 steps, for
    4 slots); mnist's ancestral ``return_history`` trajectory written as a
    GIF; a pinned labml ``SamplerService`` request alone, then batched
    with another, bit-identical; mnist once more at bf16,
    and custom's checkpoint sampled at bf16 (no second fit)."""
    import os
    import shutil

    from diffusionmodel_tpu_torch.config import preset
    from diffusionmodel_tpu_torch.device_check import fp32_compute
    from diffusionmodel_tpu_torch.diffusion import Schedule, sample_cfg
    from diffusionmodel_tpu_torch.serving import SamplerService
    from diffusionmodel_tpu_torch.utils.animation import (
        reference_frame_indices,
        save_denoising_gif,
    )

    for name, over in SIDE.items():
        fp32_ckpt = None
        for dtype in (("float32", "bfloat16") if name != "labml"
                      else ("float32",)):
            run = os.path.join(out_dir, f"{name}_{dtype}")
            cfg = preset(name, **over, **{
                "model.dtype": dtype, "train.eval_every": 0,
                "train.min_save_ep": 0, "train.save_dir": run,
                "sample.sample_dir": os.path.join(run, "samples")})
            # custom's bf16 repeat samples the float32 run's checkpoint
            # instead of training again (cuDNN's bf16 search alone took
            # ~25 s of a one-step epoch)
            got = _side_run(name, cfg, _side_dataset(name, cfg),
                            ckpt=fp32_ckpt if name == "custom" else None)
            fp32_ckpt = got["ckpt"]
            model, dc = got["model"], cfg.diffusion
            if name == "mnist" and dtype == "float32":
                t0 = time.perf_counter()
                with fp32_compute(torch.device("cuda")):
                    x, hist = sample_cfg(
                        model.eval(), torch.Generator(device="cuda")
                        .manual_seed(6), 10, (28, 28, 1), 10,
                        Schedule.create(dc.beta1, dc.beta2, dc.n_T, "cuda"),
                        dc, guide_w=2.0, return_history=True)
                hist_s = time.perf_counter() - t0
                gif = save_denoising_gif(hist, os.path.join(run, "mnist.gif"))
                from PIL import Image

                frames = Image.open(gif).n_frames
                emit("side_families", preset=name, run="gif",
                     history=list(hist.shape), seconds=hist_s,
                     frames=frames, bytes=os.path.getsize(gif))
                check(frames == len(reference_frame_indices(dc.n_T))
                      and torch.equal(hist[-1], x)
                      and bool(torch.isfinite(hist).all()), "mnist GIF")
            if name == "labml":
                sched = Schedule.create(dc.beta1, dc.beta2, dc.n_T, "cuda")
                t0 = time.perf_counter()
                with SamplerService(model, cfg, sched, max_batch=2,
                                    service_seed=0) as svc:
                    imgs = svc.generate([0], guide_w=0.0, seed=3)
                    alone_s = time.perf_counter() - t0
                    futs = [svc.submit([0], guide_w=4.0),
                            svc.submit([0], guide_w=0.0, seed=3)]
                    outs = [f.result(timeout=600) for f in futs]
                    stats = dict(svc.stats)
                svc_s = time.perf_counter() - t0
                pin_err = float(np.abs(outs[1] - imgs).max())
                emit("side_families", preset=name, run="service",
                     kind="textbook", steps=dc.n_T, first_request_s=alone_s,
                     pinned_alone_vs_batched_max_abs=pin_err,
                     seconds=svc_s, stats=stats)
                check(all(o.shape == (1, 64, 64, 3)
                          and bool(np.isfinite(o).all())
                          for o in [imgs] + outs), "labml service")
                check(stats["batches"] == 2,
                      f"labml: two requests took {stats['batches'] - 1} "
                      "batches")
                check(pin_err == 0.0,
                      f"labml: pinned request moved by {pin_err}")
            del got, model
            torch.cuda.empty_cache()
        shutil.rmtree(out_dir, ignore_errors=True)


def phase_clip(out_dir) -> None:
    """A tiny random-config ``CLIPTextModel`` (transformers' PyTorch one,
    width 64 = the ``tiny`` LDM arch's d_cond) with a minimal vocab written
    to a directory, on the card through ``CLIPTextEmbedder``: its output
    against the same model on the CPU, then one ``LdmRunner(arch="tiny",
    embedder=...)`` txt2img conditioned by it (DDIM-10, 64 px)."""
    import json
    import os

    from transformers import CLIPTextConfig, CLIPTextModel, CLIPTokenizer

    from diffusionmodel_tpu_torch.models.latent_diffusion.latent_diffusion import (  # noqa: E501
        CLIPTextEmbedder,
    )
    from diffusionmodel_tpu_torch.models.latent_diffusion.runner import (
        LdmRunner,
    )

    d = os.path.join(out_dir, "clip")
    os.makedirs(d, exist_ok=True)
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1}
    for i, t in enumerate(["a</w>", "crack</w>", "road</w>", "in</w>",
                           "the</w>", "photo</w>", "of</w>"]):
        vocab[t] = i + 2
    with open(os.path.join(d, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(d, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
    tok = CLIPTokenizer(os.path.join(d, "vocab.json"),
                        os.path.join(d, "merges.txt"))
    torch.manual_seed(0)
    model = CLIPTextModel(CLIPTextConfig(
        vocab_size=len(vocab), hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=2,
        max_position_embeddings=77)).eval()
    prompts = ["a crack in the road", ""]
    want = CLIPTextEmbedder(tokenizer=tok, model=model)(prompts)
    emb = CLIPTextEmbedder(tokenizer=tok, model=model.to("cuda"))
    got = emb(prompts)
    rel = ((got.cpu() - want).norm() / want.norm()).item()
    runner = LdmRunner(arch="tiny", steps=10, verbose=False, device="cuda",
                       embedder=emb)
    t0 = time.perf_counter()
    img = runner.txt2img("a photo of a crack", h=64, w=64,
                         generator=torch.Generator(device="cuda")
                         .manual_seed(0))
    txt_s = time.perf_counter() - t0
    same = torch.equal(runner.cond(["a crack"]), emb(["a crack"]))
    import transformers

    emit("clip", transformers=transformers.__version__,
         embed_shape=list(got.shape), device=str(got.device),
         card_vs_cpu_rel_l2=rel, txt2img_seconds=txt_s,
         image_shape=list(img.shape), conditioned_by_clip=same)
    check(got.shape == (2, 77, 64) and got.device.type == "cuda"
          and rel <= FORWARD_RTOL, f"CLIP on the card {rel}")
    check(same and img.shape == (1, 64, 64, 3)
          and bool(np.isfinite(img).all()), "txt2img through CLIP")


def timed(name: str, fn, *args, **kw):
    """``fn(*args, **kw)``, with a line giving the phase's seconds."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kw)
    finally:
        emit("seconds", name=name, seconds=time.perf_counter() - t0)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


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
    from diffusionmodel_tpu_torch.kernels.group_norm import group_norm_act
    from diffusionmodel_tpu_torch.kernels.se_block import se_block

    counters = [se_block, coord_attn]
    # the bf16 sampling phases also count the GroupNorm + activation kernel
    bf16_counters = counters + [group_norm_act]
    env = timed("env", phase_env)
    timed("build", phase_build)
    counts = timed("counts", fresh_kernel_counts)
    rows = timed("kernels", phase_kernels, counts)
    bf16_rows = timed("kernels_bf16", phase_kernels_bf16, counts)
    gn_rows = timed("group_norm", phase_group_norm)
    slab_rows = timed("spatial_kernels", phase_spatial_kernels)
    flash_rows = timed("flash", phase_flash)
    cfg, model = timed("forward", phase_forward, counters, counts)
    launches = timed("serve", phase_serve, cfg, model, counters, env)
    del model
    torch.cuda.empty_cache()
    timed("forward_bf16", phase_forward_bf16, bf16_counters)
    bf16_launches = timed("serve_bf16", phase_serve_bf16, bf16_counters,
                          env)
    timed("ldm_forward", phase_ldm_forward, flash_attention)
    flash_launches = timed("ldm", phase_ldm, flash_attention, env)
    flash_counters = [flash_attention, flash_attention_dq, flash_attention_dkv]
    bwd_rows = timed("flash_bwd", phase_flash_bwd)
    timed("ldm_grad", phase_ldm_grad, flash_counters)
    train_launches = timed("train_ldm", phase_train_ldm, flash_counters)
    import importlib.util
    import os
    import shutil

    out_root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "output")
    flagship_dir = os.path.join(out_root, "chip_smoke_flagship")
    flag_cfg, flag_ckpt, fit_launches, dataset = timed(
        "train", phase_train, counters, flagship_dir)
    gen_launches, gen_images = timed("generate", phase_generate, counters,
                                     flag_cfg, flag_ckpt, flagship_dir,
                                     dataset)
    timed("eval", phase_eval, gen_images, dataset, flagship_dir)
    # the best checkpoint holds no optimizer state: half the bytes to load
    best = os.path.join(os.path.dirname(flag_ckpt), "best_model")
    edit_launches = timed("edit", phase_edit, counters, flag_cfg, best,
                          flagship_dir, dataset)
    timed("edit_cli", phase_edit_cli, best, flagship_dir, dataset)
    timed("pt_checkpoint", phase_pt_checkpoint, flag_cfg, best,
          flagship_dir)
    shutil.rmtree(flagship_dir, ignore_errors=True)  # multi-GB checkpoints
    bf16_dir = flagship_dir + "_bf16"
    bf16_fit_launches = timed("train_bf16", phase_train_bf16, counters,
                              bf16_dir, dataset)
    parallel_launches = timed("parallel", phase_parallel, counters,
                              os.path.join(out_root, "chip_smoke_parallel"),
                              dataset)
    shutil.rmtree(os.path.join(out_root, "chip_smoke_parallel"),
                  ignore_errors=True)
    mesh_dir = os.path.join(out_root, "chip_smoke_spatial")
    mesh_runs = timed("spatial", phase_spatial, mesh_dir)
    spatial_launches, model_launches = timed(
        "mesh_reference", phase_mesh_reference, mesh_runs)
    del mesh_runs
    shutil.rmtree(mesh_dir, ignore_errors=True)
    base = _flagship_train_cfg(bf16_dir)
    cfg16 = base.replace(model=dataclasses.replace(
        base.model, dtype="bfloat16", fused_upsample=True))
    edit16_launches = timed(
        "edit_bf16", phase_edit, counters, cfg16,
        os.path.join(bf16_dir, "run", "best_model"), bf16_dir, dataset,
        tag="edit_bf16")
    shutil.rmtree(bf16_dir, ignore_errors=True)
    side_dir = os.path.join(out_root, "chip_smoke_side")
    timed("side_families", phase_side_families, side_dir)
    if importlib.util.find_spec("transformers") is not None:
        timed("clip", phase_clip, side_dir)
    else:
        emit("clip", transformers=None, ran=False)
    shutil.rmtree(side_dir, ignore_errors=True)

    def entry(name, key, launched, replaces, table=rows):
        sites = table[key]
        return {
            "name": name, "route": "cuda",
            "source": f"diffusionmodel_tpu_torch/kernels/csrc/{key}.cu",
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
            "kernels_per_call": max(s["kernels_per_call"] for s in sites),
            "design_bound_ms": sum(s["design_bound_ms"] for s in sites),
            "bound_share": sum(s["bound_ms"] for s in sites)
            / sum(s["ms"] for s in sites),
            "site_ms": [s["ms"] for s in sites],
            "timed_over": f">= {ROTATE_BYTES / 1e6:.0f} MB of rotating "
                          "copies of x",
            **({"bytes_reread": sum(s["bytes_reread"] for s in sites),
                "dram_bytes_read": [s["dram_bytes_read"] for s in sites]}
               if key == "se_block" else {}),
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

    def slab_entry(name, key, dtype, stages, replaces):
        sites = [r for r in slab_rows[dtype][key]
                 if r["shards"] == SPATIAL_RANKS]
        counts = spatial_launches.get(dtype, [0] * len(SPATIAL_COUNTERS))
        return {
            "name": name, "route": "cuda",
            "source": "diffusionmodel_tpu_torch/kernels/csrc/"
                      f"{key.replace('_slab', '')}.cu",
            "replaces": replaces,
            "launches": min(counts[j] for j in stages),
            "stage_launches": {SPATIAL_COUNTERS[j]: counts[j]
                               for j in stages},
            "max_abs_err": max(r["max_abs_err"] for r in
                               slab_rows[dtype][key]),
            "max_abs_err_whole_map": max(r["max_abs_err_whole"] for r in
                                         slab_rows[dtype][key]),
            "ms": sum(r["ms"] for r in sites),
            "plain_ms": sum(r["plain_ms"] for r in sites),
            "bound_ms": sum(r["bound_ms"] for r in sites),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                       for r in sites) else "operations",
            "library_ms": None,
            "whole_map_ms": sum(r["whole_ms"] for r in sites),
            "dtype": dtype,
            "per": f"one process's share of a batch-{BATCH} forward at "
                   f"{SPATIAL_RANKS} slabs ({len(sites)} sites, back to "
                   "back); whole_map_ms the whole-map kernel on the whole "
                   "map; launches on the two-rank spatial path: the calls "
                   "of the stage called least, each stage's in "
                   "stage_launches (counted where it launches)",
        }

    gn_entry = {
        "name": "group_norm_act", "route": "cuda",
        "source": "diffusionmodel_tpu_torch/kernels/csrc/group_norm.cu",
        "replaces": None, "dtype": "bfloat16",
        "launches": bf16_launches[2],
        "max_ulps": max(r["max_ulps"] for r in gn_rows["rows"]),
        "ms": gn_rows["ms"], "plain_ms": gn_rows["plain_ms"],
        "bound_ms": gn_rows["bound_ms"], "bound_by": "bytes",
        "bound_share": gn_rows["bound_ms"] / gn_rows["ms"],
        "library_ms": None,
        "per": f"one bf16 batch-{BATCH} sampling forward ("
               f"{len(GN_SITES)} sites, {GN_PER_FORWARD} calls); launches "
               "on the bf16 serving path",
        "site_ms": [r["ms"] for r in gn_rows["rows"]],
        "timed_over": f">= {ROTATE_BYTES / 1e6:.0f} MB of rotating "
                      "copies of x",
    }
    fwd = flash_entry(flash_rows, flash_launches)
    fwd["train_launches"] = train_launches[0]
    se = entry("se_block", "se_block", launches[0],
               "diffusionmodel_tpu/kernels/se_block.py:202")
    ca = entry("coord_attn", "coord_attn", launches[1],
               "diffusionmodel_tpu/kernels/coord_attn.py:296")
    # the whole-map kernels' calls on the two-rank model-axis path
    model_counts = {dt: dict(zip(SPATIAL_COUNTERS, c))
                    for dt, c in model_launches.items()}
    for row, i in ((se, 0), (ca, 1)):
        row["train_launches"] = fit_launches[i]
        row["generate_launches"] = gen_launches[i]
        row["edit_launches"] = edit_launches[i]
        row["model_axis_launches"] = model_counts.get("float32", {}).get(
            row["name"])
    # the bf16 forms: launches on the bf16 serving path (and bf16 fit)
    se16 = entry("se_block_bf16", "se_block", bf16_launches[0],
                 "diffusionmodel_tpu/kernels/se_block.py:202", bf16_rows)
    ca16 = entry("coord_attn_bf16", "coord_attn", bf16_launches[1],
                 "diffusionmodel_tpu/kernels/coord_attn.py:296", bf16_rows)
    for row, i in ((se16, 0), (ca16, 1)):
        row["train_launches"] = bf16_fit_launches[i]
        row["edit_launches"] = edit16_launches[i]
        row["parallel_launches"] = parallel_launches[i]
        row["model_axis_launches"] = model_counts.get("bfloat16", {}).get(
            "se_block" if i == 0 else "coord_attn")
        row["dtype"] = "bfloat16"
        row["rel_l2"] = max(s["rel_l2"] for s in bf16_rows[
            "se_block" if i == 0 else "coord_attn"])
    print(json.dumps({"kernels": [
        se,
        ca,
        se16,
        ca16,
        gn_entry,
        slab_entry("se_block_slab", "se_block_slab", "float32", (0, 1),
                   "diffusionmodel_tpu/kernels/se_block.py:202"),
        slab_entry("coord_attn_slab", "coord_attn_slab", "float32",
                   (2, 3, 4), "diffusionmodel_tpu/kernels/coord_attn.py:296"),
        slab_entry("se_block_slab_bf16", "se_block_slab", "bfloat16", (0, 1),
                   "diffusionmodel_tpu/kernels/se_block.py:202"),
        slab_entry("coord_attn_slab_bf16", "coord_attn_slab", "bfloat16",
                   (2, 3, 4), "diffusionmodel_tpu/kernels/coord_attn.py:296"),
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
