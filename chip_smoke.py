#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's three main paths at full width, with weights drawn
from fixed torch seeds: the ContextUnet serving path of ``preset("full")``
(ContextUnet v2, n_feat 192, 256 px, 5 classes, GroupNorm, 353M
parameters) with ``model.use_pallas=True``, so that SE and CoordAttn run
through the hand-written CUDA kernels; the latent-diffusion path
(``LdmRunner(arch="sd")``: the SD-v1 UNet, 860M parameters, and VAE at
512 px), whose level-0 self-attention runs through the hand-written
flash-attention kernel; and LDM training on that runner (``fit_ldm``,
``fit_ae``), whose backward runs the two hand-written flash-attention
backward kernels. Phases, each printing JSON lines:

1. env      the card (nvidia-smi's name and power limit), torch/CUDA
            versions, and the TF32 settings, both switched off: every
            number here is float32.
2. build    nvcc for each kernel source, all in parallel: registers and
            spill bytes per kernel (ptxas), and the flash backward
            kernels' tensor-core instructions (cuobjdump -sass); fails if
            a backward kernel spills or has no HMMA.
3. kernels  each kernel against its plain PyTorch twin at every site the
            flagship forward gives it at batch 16 (CoordAttn under both
            norm kinds): max |diff| (tolerance 1e-4 on standard-normal
            inputs: the same fp32 arithmetic summed in another order),
            kernel and twin times, and the least time the card could take.
4. flash    the flash-attention kernel against its twin (output and
            logsumexp) at the SD UNet's 512 px site (4, 4096, 8, 40), a
            ragged 416 px site, D = 80 and 160, an M != N case and the tiny
            and mid head dims: max |diff| (tolerance 1e-4 on standard-normal
            inputs: the same fp32 arithmetic summed in another order, with
            exp2 in place of exp), kernel, twin and SDPA times, the bound.
5. forward  one full-width forward at batch 16 through the kernels against
            the plain path on the same weights (relative L2 tolerance
            1e-4), with 5 SE and 4 CoordAttn launches.
6. serve    the ContextUnet main path, with every launch count zeroed just
            before it:
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
            launch counts zeroed just before it: txt2img DDIM-50 at 512 px
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

Then a ``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises: the exit code is
not 0 and the last line is not printed. Without CUDA it exits 2 at once.
"""

from __future__ import annotations

import base64
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
BWD_RTOL = 1e-4  # backward kernels: max |diff| over max |reference|
GRAD_RTOL = 1e-4  # relative L2 of a whole UNet gradient, kernels vs plain
TRAIN_IMAGES, TRAIN_BATCH, TRAIN_EPOCHS = 8, 2, 2
# (H, C) of each site in one flagship forward, in forward order.
SE_SITES = [(256, 192), (256, 192), (128, 384), (64, 768), (32, 1536)]
CA_SITES = [(128, 192), (64, 384), (32, 768), (16, 1536)]


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


def kernel_breakdown(fn) -> tuple:
    """Profile one call of ``fn`` (torch.profiler, CUDA activity): device ms
    per kernel name (the port's kernels by their short names), the busy ms
    (the union of the kernels' intervals) and the wall ms of the call.
    Only kernel events are counted, and an event the profiler reports twice
    (same name and interval) once."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out, seen = {}, set()
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type != DeviceType.CUDA or end <= start \
                or (e.name, start, end) in seen:
            continue
        seen.add((e.name, start, end))
        short = re.search(r"\b(?:se|ca)_[a-z_]+(?=\()|flash_(?:fwd|bwd_dq|"
                          r"bwd_dkv)<\d+(?:, ?(?:\d+|true|false))*>", e.name)
        name = short.group(0) if short else e.name[:80]
        out[name] = out.get(name, 0.0) + (end - start) / 1e3
    busy_us, reach = 0.0, float("-inf")
    for _, start, end in sorted(seen, key=lambda s: s[1]):
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    return out, busy_us / 1e3, wall_ms


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
    return {"nvidia_smi": smi}


def _flash_name(mangled: re.Match) -> str:
    """flash_bwd_dkv<40,32,0> from the mangled ``flash_bwd_dkvILi40ELi32ELb0EE``
    (template arguments: the head dim first, then the tile shape)."""
    return "%s<%s>" % (mangled.group(1),
                       ",".join(re.findall(r"L[ib](\d+)E", mangled.group(2))))


_FLASH_MANGLED = r"(flash_(?:fwd|bwd_dq|bwd_dkv))I((?:L[ib]\d+E)+)E"


def _sass_mma(lib_path) -> dict:
    """Per flash backward kernel in the built library, its tensor-core
    instructions by ``cuobjdump -sass``: the count of HMMA lines and the
    first one. Empty where the toolkit has no cuobjdump."""
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
            fn = re.search(r"(?:se|ca)_[a-z_]+(?=E)", chunk)
            flash = re.search(_FLASH_MANGLED, chunk)
            used = re.search(r"Used (\d+) registers", chunk)
            spill = re.search(r"(\d+) bytes spill stores", chunk)
            if flash and used:
                regs[_flash_name(flash)] = int(used.group(1))
                spills[_flash_name(flash)] = int(spill.group(1)) if spill else 0
            elif fn and used:
                regs[fn.group(0)] = int(used.group(1))
    sass = _sass_mma(_build.library_path("flash_attn_bwd"))
    emit("build", seconds=time.monotonic() - t0,
         per_source={k: v["seconds"] for k, v in report.items()},
         registers=regs, spill_store_bytes=spills, bwd_sass_hmma=sass)
    bwd = {name: (name.split("<")[0], int(name.split("<")[1].split(",")[0]))
           for name in spills if name.startswith("flash_bwd")}
    check(sorted(bwd.values()) == sorted(
        (f"flash_bwd_{p}", d) for p in ("dq", "dkv") for d in HEAD_DIMS),
        f"one dQ and one dK/dV kernel per head dim: {sorted(bwd)}")
    check(all(spills[name] == 0 for name in bwd),
          f"backward kernels spill: {spills}")
    check(not sass or all(sass.get(name, {}).get("hmma", 0) > 0
                          for name in bwd),
          f"backward kernels without tensor-core (HMMA) instructions: {sass}")


def _site_x(b, h, c, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((b, h, h, c), generator=g, device="cuda")


def phase_kernels() -> list:
    from diffusionmodel_tpu_torch.kernels.coord_attn import (
        CoordAttnWeights,
        coord_attn,
        coord_attn_plain,
    )
    from diffusionmodel_tpu_torch.kernels.se_block import (
        se_block,
        se_block_plain,
    )
    from diffusionmodel_tpu_torch.nn.blocks import gn_groups
    from diffusionmodel_tpu_torch.nn.coord_attn import CoordAttn

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
                r = c // 16
                torch.manual_seed(200 + i)
                mod = CoordAttn(c, 16, norm="group" if kind == "group"
                                else "batch").cuda().eval()
                g = torch.Generator(device="cuda").manual_seed(300 + i)
                for p in (mod.gamma_h, mod.gamma_w, mod.alpha, mod.beta):
                    p.copy_(torch.randn(1, generator=g, device="cuda"))
                for nl in (mod.bn1_h, mod.bn1_w):
                    nl.weight.copy_(1 + 0.1 * torch.randn(
                        r, generator=g, device="cuda"))
                    nl.bias.copy_(0.1 * torch.randn(r, generator=g,
                                                    device="cuda"))
                    if kind == "affine":
                        nl.running_mean.copy_(0.1 * torch.randn(
                            r, generator=g, device="cuda"))
                        nl.running_var.copy_(torch.rand(
                            r, generator=g, device="cuda") + 0.5)
                wts = CoordAttnWeights.from_module(mod, kind)
                groups = gn_groups(r, 8)
                x = _site_x(BATCH, h, c, 10 + i)
                err = (coord_attn(x, wts, kind, groups)
                       - coord_attn_plain(x, wts, kind, groups)
                       ).abs().max().item()
                xb = x.numel() * 4
                wbytes = sum(t.numel() * 4 for t in vars(wts).values())
                mlp = BATCH * 2 * h * (2 * c * r + 2 * r * r + 2 * r * c)
                b_ms, b_by = bound(2 * xb + wbytes, 4 * x.numel() + mlp)
                rows[key].append(dict(
                    shape=list(x.shape), norm_kind=kind, max_abs_err=err,
                    ms=cuda_ms(lambda: coord_attn(x, wts, kind, groups), 20),
                    plain_ms=cuda_ms(
                        lambda: coord_attn_plain(x, wts, kind, groups), 10),
                    device_ms=device_times(
                        lambda: coord_attn(x, wts, kind, groups)),
                    bound_ms=b_ms, bound_by=b_by,
                    design_bound_ms=3 * xb / HBM_BYTES_PER_S * 1e3))
                emit("kernels", kernel="coord_attn", **rows[key][-1])
                check(err <= KERNEL_ATOL,
                      f"coord_attn {kind} {x.shape}: |diff| {err}")
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
    total = sum(by_kernel.values())
    ours = sum(v for k, v in by_kernel.items() if k[:3] in ("se_", "ca_"))
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    emit("forward", device_ms=total, se_ca_device_ms=ours,
         top_kernels=[[k, v] for k, v in top])
    emit("forward", params=n_params, shape=list(got.shape),
         se_launches=launched[0], ca_launches=launched[1], rel_l2=rel,
         max_abs_err=(got - want).abs().max().item(),
         max_abs_out=want.abs().max().item(), ms=times)
    check(n_params > 300e6, f"flagship has {n_params} parameters")
    check(tuple(got.shape) == (BATCH, 256, 256, 3)
          and bool(torch.isfinite(got).all()), "forward output")
    check(launched == [5, 4], f"launches per forward {launched}")
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


def phase_serve(cfg, model, counters) -> list:
    from diffusionmodel_tpu_torch.diffusion import Schedule, sample_cfg
    from diffusionmodel_tpu_torch.serving import SamplerService

    dc = cfg.diffusion
    sched = Schedule.create(dc.beta1, dc.beta2, dc.n_T, "cuda")
    for f in counters:
        f.launches = 0
    t_serve = time.perf_counter()

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
    with torch.no_grad():
        for i, (b, n, m, h, d) in enumerate(FLASH_SITES):
            g = torch.Generator(device="cuda").manual_seed(500 + i)
            q = torch.randn((b, n, h, d), generator=g, device="cuda")
            k = torch.randn((b, m, h, d), generator=g, device="cuda")
            v = torch.randn((b, m, h, d), generator=g, device="cuda")
            o, lse = flash_attention(q, k, v, want_lse=True)
            want_o, want_lse = flash_attention_plain(q, k, v, want_lse=True)
            err = (o - want_o).abs().max().item()
            err_lse = (lse - want_lse).abs().max().item()
            del o, lse, want_o, want_lse
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            iters = 10 if (b, n, m, h, d) == FLASH_MAIN else 3
            b_ms, b_by = bound(4 * (2 * b * n * h * d + 2 * b * m * h * d),
                               4 * b * h * n * m * d)
            rows.append(dict(
                shape=[b, n, m, h, d], max_abs_err=err,
                max_abs_err_lse=err_lse,
                ms=cuda_ms(lambda: flash_attention(q, k, v), iters),
                plain_ms=cuda_ms(lambda: flash_attention_plain(q, k, v),
                                 iters),
                library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt), iters),
                device_ms=device_times(lambda: flash_attention(q, k, v)),
                bound_ms=b_ms, bound_by=b_by))
            rows[-1]["bound_share"] = b_ms / rows[-1]["ms"]
            emit("flash", **rows[-1])
            check(max(err, err_lse) <= KERNEL_ATOL,
                  f"flash_attn {[b, n, m, h, d]}: |diff| {err}, lse {err_lse}")
            del q, k, v, qt, kt, vt
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


def phase_ldm(flash) -> int:
    from diffusionmodel_tpu_torch.models.latent_diffusion.runner import (
        LdmRunner,
    )

    t0 = time.perf_counter()
    runner = LdmRunner(arch="sd", device="cuda", verbose=False)
    emit("ldm", build_s=time.perf_counter() - t0)
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
    phase_env()
    phase_build()
    rows = phase_kernels()
    flash_rows = phase_flash()
    cfg, model = phase_forward(counters)
    launches = phase_serve(cfg, model, counters)
    del model
    torch.cuda.empty_cache()
    phase_ldm_forward(flash_attention)
    flash_launches = phase_ldm(flash_attention)
    flash_counters = [flash_attention, flash_attention_dq, flash_attention_dkv]
    bwd_rows = phase_flash_bwd()
    phase_ldm_grad(flash_counters)
    train_launches = phase_train_ldm(flash_counters)

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
            "library_ms": per * main_site["library_ms"],
            "per": f"one batch-4 SD UNet forward at 512 px ({per} sites of "
                   f"(B, N, M, H, D) = {list(FLASH_MAIN)})",
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
    print(json.dumps({"kernels": [
        entry("se_block", "se_block", launches[0],
              "diffusionmodel_tpu/kernels/se_block.py:202"),
        entry("coord_attn", "coord_attn", launches[1],
              "diffusionmodel_tpu/kernels/coord_attn.py:296"),
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
