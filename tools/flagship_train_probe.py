#!/usr/bin/env python3
"""Where the flagship train step's time goes, on one card.

    python3 tools/flagship_train_probe.py [--modes off|on] [--steps 2]
                                          [--forward-batches 16,20]
                                          [--ops]

Builds ``preset("full")`` (ContextUnet v2, n_feat 192, 256 px, 353M
parameters, ``use_pallas``) in fp32 with TF32 off, and for each cuDNN
algorithm mode (``off``: PyTorch's default heuristics; ``on``:
``torch.backends.cudnn.benchmark``, which times the algorithms per shape
once; each mode in a process of its own, as cuDNN caches the plans it
picked per shape across the switch) prints JSON lines with:

- the CUDA-event ms of an eval forward at each batch in
  ``--forward-batches`` (16: the serving batch; 20: a 10-slot CFG sweep);
- the wall seconds of ``--steps`` optimizer steps of ``make_train_step``
  (4 micro-batches of 4, full remat, AdamW with a bf16 first moment,
  EMA), after one untimed step;
- one more step under ``torch.profiler``: busy and idle share and the top
  device kernels, with the FFT convolution kernels (cuDNN's ``fft`` and
  complex ``cf32`` GEMMs) summed apart;
- the ms of one micro-batch's loss + backward, and of the optimizer
  update and EMA alone.

``--ops`` instead profiles one micro-batch's loss + backward and one
eval forward at the last of ``--forward-batches`` with
``record_shapes``, and prints the convolution ops (forward and backward)
by input shape with their device ms, and the top device kernels of each.

Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sync_s(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--modes", default="off")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--forward-batches", default="16,20")
    ap.add_argument("--ops", action="store_true")
    args = ap.parse_args()
    cs = _chip_smoke()
    cs.phase_env()

    from diffusionmodel_tpu_torch.config import preset
    from diffusionmodel_tpu_torch.diffusion import Schedule, train_loss
    from diffusionmodel_tpu_torch.nn import build_model
    from diffusionmodel_tpu_torch.train import (
        apply_updates_,
        create_train_state,
        decode_wire,
        make_train_step,
        update_ema_,
    )

    cfg = preset("full", **{"model.use_pallas": True,
                            "train.ema_decay": 0.9995})
    tc, dc = cfg.train, cfg.diffusion
    torch.manual_seed(0)
    model = build_model(cfg.model, dc.high_thresh, device="cuda")
    sched = Schedule.create(dc.beta1, dc.beta2, dc.n_T, "cuda")
    state, opt = create_train_state(model, cfg, 2)
    step = make_train_step(model, sched, cfg, opt)
    rng = np.random.default_rng(0)
    batch = {"x": rng.integers(0, 256, (tc.accum_steps, tc.batch_size, 256,
                                        256, 3), dtype=np.uint8),
             "c": rng.integers(0, 5, (tc.accum_steps, tc.batch_size)),
             "mask": rng.integers(0, 3, (tc.accum_steps, tc.batch_size,
                                         256, 256), dtype=np.uint8)}
    gen = torch.Generator(device="cuda").manual_seed(1)

    if args.ops:
        return _ops(model, sched, cfg, batch, gen,
                    int(args.forward_batches.split(",")[-1]))
    for mode in args.modes.split(","):
        torch.backends.cudnn.benchmark = mode == "on"
        fwd = {}
        for b in (int(v) for v in args.forward_batches.split(",")):
            g = torch.Generator(device="cuda").manual_seed(b)
            x = torch.randn((b, 256, 256, 3), generator=g, device="cuda")
            c = torch.arange(b, device="cuda") % 5
            t = torch.rand(b, generator=g, device="cuda")
            ctx = torch.ones(b, device="cuda")
            with torch.no_grad():
                model.eval()
                fwd[b] = cs.cuda_ms(lambda: model(x, c, t, ctx), 3)
            del x
        print(json.dumps({"mode": mode, "eval_forward_ms": fwd}), flush=True)

        torch.cuda.reset_peak_memory_stats()
        first = _sync_s(lambda: step(state, batch, gen))
        secs = [_sync_s(lambda: step(state, batch, gen))
                for _ in range(args.steps)]
        by_kernel, busy_ms, wall_ms = cs.kernel_breakdown(
            lambda: step(state, batch, gen))
        fft = {k: v for k, v in by_kernel.items()
               if "fft" in k.lower() or "cf32" in k}
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]

        # one micro-batch's loss + backward, then the update and EMA alone
        x, mask = decode_wire(torch.from_numpy(batch["x"][0]).cuda(),
                              torch.from_numpy(batch["mask"][0]).cuda(), dc,
                              True)
        cc = torch.from_numpy(batch["c"][0]).cuda()
        model.train()

        def micro():
            train_loss(model, x, cc, mask, sched, dc,
                       generator=gen).backward()

        micro_s = [_sync_s(micro) for _ in range(2)]
        grads = [p.grad.clone() for p in model.parameters()]
        model.zero_grad(set_to_none=True)
        model.eval()
        upd_s = _sync_s(lambda: apply_updates_(opt, state.opt_state,
                                               state.params,
                                               [g.clone() for g in grads]))
        ema_s = _sync_s(lambda: update_ema_(state, tc.ema_decay))
        del grads
        print(json.dumps({
            "mode": mode, "first_step_s": first, "step_s": secs,
            "images_per_s": tc.batch_size * tc.accum_steps / min(secs),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "profiled_wall_ms": wall_ms, "busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "device_ms": sum(by_kernel.values()),
            "fft_conv_ms": sum(fft.values()),
            "top_kernels": [[k, v] for k, v in top],
            "micro_batch_loss_backward_s": micro_s,
            "update_s": upd_s, "ema_s": ema_s}), flush=True)
        torch.cuda.empty_cache()
    return 0


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _ops(model, sched, cfg, batch, gen, fwd_batch) -> int:
    """Convolution ops by input shape, and top kernels, over one
    micro-batch's loss + backward and one eval forward."""
    from torch.profiler import ProfilerActivity, profile

    from diffusionmodel_tpu_torch.diffusion import train_loss
    from diffusionmodel_tpu_torch.train import decode_wire

    dc = cfg.diffusion
    x, mask = decode_wire(torch.from_numpy(batch["x"][0]).cuda(),
                          torch.from_numpy(batch["mask"][0]).cuda(), dc, True)
    cc = torch.from_numpy(batch["c"][0]).cuda()

    def micro():
        model.train()
        train_loss(model, x, cc, mask, sched, dc, generator=gen).backward()
        model.zero_grad(set_to_none=True)
        model.eval()

    g = torch.Generator(device="cuda").manual_seed(0)
    xf = torch.randn((fwd_batch, 256, 256, 3), generator=g, device="cuda")
    cf = torch.arange(fwd_batch, device="cuda") % 5
    tf = torch.rand(fwd_batch, generator=g, device="cuda")

    def forward():
        with torch.no_grad():
            model.eval()(xf, cf, tf, torch.ones(fwd_batch, device="cuda"))

    for name, fn in (("micro_batch_loss_backward", micro),
                     (f"eval_forward_b{fwd_batch}", forward)):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            fn()
            torch.cuda.synchronize()
        rows = []
        for evt in prof.key_averages(group_by_input_shape=True):
            if "conv" in evt.key or "addmm" in evt.key or "bmm" in evt.key:
                rows.append([evt.key, str(evt.input_shapes)[:160],
                             evt.count, _device_us(evt) / 1e3])
        rows.sort(key=lambda r: -r[3])
        kernels = sorted(((e.key[:90], _device_us(e) / 1e3)
                          for e in prof.key_averages()
                          if _device_us(e) > 0 and not e.key.startswith(
                              "aten::")), key=lambda kv: -kv[1])[:8]
        print(json.dumps({"profile": name, "ops_ms": rows[:25],
                          "top_kernels": kernels}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
