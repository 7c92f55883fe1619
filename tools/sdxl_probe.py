#!/usr/bin/env python3
"""Time the flash-attention forward kernel against the plain path at
SDXL's self-attention sites on one card, to set the ``sdxl`` arch's flash
gate (``flash_min_seq``).

    python3 tools/sdxl_probe.py [--reps 20] [--out FILE]

Sites (b, n, heads, d) at 1024 px under guidance's doubled batch: level 1
(2, 4096, 10, 64) and level 2 and the middle (2, 1024, 20, 64). The plain
path is ``CrossAttention``'s own below the gate (einsum, softmax, einsum:
``flash_attention_plain``), the kernel ``flash_attention``; both in
float32 with TF32 off (``fp32_compute``). Each is timed by CUDA events
over ``--reps`` calls, in turns (plain, flash, flash, plain), on fresh
contiguous q, k, v as ``to_q`` / ``to_k`` / ``to_v`` give them, with the
max |o - plain o|. Prints the card, then one JSON line per site.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from diffusionmodel_tpu_torch.device_check import fp32_compute  # noqa: E402
from diffusionmodel_tpu_torch.kernels.flash_attn import (  # noqa: E402
    flash_attention,
    flash_attention_plain,
)

SITES = [(2, 4096, 10, 64), (2, 1024, 20, 64)]


def _ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    lines = [subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()]
    with fp32_compute(dev, autotune=False), torch.inference_mode():
        for b, n, h, d in SITES:
            g = torch.Generator(dev).manual_seed(n)
            q, k, v = (torch.randn(b, n, h, d, generator=g, device=dev)
                       for _ in range(3))
            want = flash_attention_plain(q, k, v)
            diff = float((flash_attention(q, k, v) - want).abs().max())
            times = {"plain": [], "flash": []}
            fns = {"plain": lambda: flash_attention_plain(q, k, v),
                   "flash": lambda: flash_attention(q, k, v)}
            for fn in fns.values():
                fn()  # warm
            torch.cuda.synchronize()
            for name in ("plain", "flash", "flash", "plain"):
                times[name].append(_ms(fns[name], args.reps))
            lines.append(json.dumps({
                "site": [b, n, h, d], "plain_ms": times["plain"],
                "flash_ms": times["flash"], "max_abs_diff": diff,
                "faster": min(times, key=lambda k: min(times[k]))}))
    text = "\n".join(lines)
    print(text, flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
