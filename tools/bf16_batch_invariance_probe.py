#!/usr/bin/env python3
"""Does a sample's bf16 output depend on where it sits in the batch? One
card, ``preset("full")`` (ContextUnet v2, n_feat 192, 256 px,
``use_pallas``) at ``model.dtype=bfloat16``, random weights from torch
seed 0, batch 16, under ``device_check.fp32_compute`` with and without
cuDNN's autotuning.

    python3 tools/bf16_batch_invariance_probe.py

For each of two ways to run the bf16 convolutions without gradients,
the port's (``kernels.per_sample_conv``: one cuDNN call per sample) and one
call for the whole batch (PyTorch's own, patched in here for the
comparison), and for the float32 net (``nn.Conv2d``'s own, one call for
the batch), prints a JSON line: whether the eval forward's output, with
the batch rolled by 3, 5, 8 and 13 slots, is the rolled output bit for
bit; the convolutions (by module name and input shape) whose own output
moves with the batch position; and the forward's ms (host clock around a
synchronised call, best of 3). Prints the card's name and power limit
first.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _best_ms(fn, n=3) -> float:
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return min(out)


def main() -> int:
    if not torch.cuda.is_available():
        print("bf16_batch_invariance_probe: CUDA is not available",
              file=sys.stderr)
        return 2
    from diffusionmodel_tpu_torch.config import preset
    from diffusionmodel_tpu_torch.device_check import fp32_compute
    from diffusionmodel_tpu_torch.nn import blocks, build_model

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(16, 256, 256, 3, generator=g, device=dev)
    c = torch.arange(16, device=dev) % 5
    t = torch.rand(16, generator=g, device=dev)
    ctx = (torch.arange(16, device=dev) >= 8).float()
    port_forward = blocks.Conv2d.forward

    def batched_forward(self, xx):  # one cuDNN call for the whole batch
        dt = self.compute_dtype
        if dt == torch.float32:
            return port_forward(self, xx)
        y = self._conv_forward(xx.to(dt), self.weight.to(dt), None)
        return y if self.bias is None else y + self.bias.to(dt)[:, None, None]

    for dtype in ("bfloat16", "float32"):
        cfg = preset("full", **{"model.use_pallas": True,
                                "model.dtype": dtype})
        torch.manual_seed(0)
        model = build_model(cfg.model, cfg.diffusion.high_thresh, device=dev)
        names = {m: n for n, m in model.named_modules()}
        ways = ((("per_sample", port_forward), ("batched", batched_forward))
                if dtype == "bfloat16"  # the float32 net: nn.Conv2d's own
                else (("batched", port_forward),))
        for way, fwd in ways:
            blocks.Conv2d.forward = fwd
            for autotune in (True, False):
                with fp32_compute(dev, autotune=autotune), torch.no_grad():
                    base = model(x, c, t, ctx)
                    rolls = {}
                    for k in (3, 5, 8, 13):
                        p = torch.roll(torch.arange(16, device=dev), k)
                        out = model(x[p], c[p], t[p], ctx[p])
                        rolls[k] = torch.equal(out[torch.argsort(p)], base)
                    inputs = {}

                    def grab(mod, args, out):
                        if isinstance(mod, torch.nn.Conv2d) \
                                and args[0].shape[0] == 16:
                            inputs.setdefault(names[mod], (mod, args[0]))

                    hook = torch.nn.modules.module \
                        .register_module_forward_hook(grab)
                    model(x, c, t, ctx)
                    hook.remove()
                    p = torch.roll(torch.arange(16, device=dev), 3)
                    moving = [[n, list(xi.shape)] for n, (mod, xi)
                              in inputs.items()
                              if not torch.equal(mod(xi[p])[torch.argsort(p)],
                                                 mod(xi))]
                    ms = _best_ms(lambda: model(x, c, t, ctx))
                print(json.dumps({
                    "dtype": dtype, "convolutions": way,
                    "autotune": autotune, "rolled_output_equal": rolls,
                    "convs_moving_with_position": moving,
                    "convs_checked": len(inputs), "forward_ms": ms,
                    "device": torch.cuda.get_device_name(0)}), flush=True)
        blocks.Conv2d.forward = port_forward
        del model
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
