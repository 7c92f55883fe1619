#!/usr/bin/env python3
"""Time the GroupNorm + activation kernel at ``chip_smoke.py``'s flagship
sites and in the bf16 flagship forward, on one card.

    python3 tools/group_norm_probe.py [--sites] [--forward N] [--out FILE]

``--sites`` runs ``chip_smoke.phase_group_norm``: each of the 13 sites of
a bf16 sampling forward at batch 16 (kernel against twin, kernel ms over
rotating copies of x, twin ms, the bound of x read once and written once)
and the per-forward sums. ``--forward N`` times
a batch-16 forward of ``preset("full")`` in bf16 (SE and CoordAttn
kernels, fused head, under ``precast_params`` and ``inference_mode``, as
the sampler runs it), best of N, with GroupNorm on the kernel and on its
plain path (``GroupNorm._takes_kernel`` forced false: the operations the
port ran before the kernel), in turns plain, kernel, kernel, plain, and
one profiled forward of each: device ms by kernel name (top 12) and the
busy ms. Prints the card's name and power limit first; ``--out`` also
writes every line to a file.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Out:
    def __init__(self, path):
        self.f = open(path, "w") if path else None

    def __call__(self, **kv):
        line = json.dumps(kv)
        print(line, flush=True)
        if self.f:
            self.f.write(line + "\n")
            self.f.flush()


def sites(cs, out) -> None:
    got = cs.phase_group_norm()
    for row in got.pop("rows"):
        out(kind="site", **row)
    out(kind="per_forward", bound_share=got["bound_ms"] / got["ms"], **got)


def forward(cs, out, best_of: int) -> None:
    from diffusionmodel_tpu_torch.config import preset
    from diffusionmodel_tpu_torch.nn import build_model
    from diffusionmodel_tpu_torch.nn.blocks import GroupNorm, precast_params

    cfg = preset("full", **{"model.use_pallas": True,
                            "model.dtype": "bfloat16",
                            "model.fused_upsample": True})
    torch.manual_seed(0)
    model = build_model(cfg.model, cfg.diffusion.high_thresh,
                        device="cuda").eval()
    b = cs.BATCH
    g = torch.Generator(device="cuda").manual_seed(1)
    args = (torch.randn((b, 256, 256, 3), generator=g, device="cuda"),
            torch.arange(b, device="cuda") % 5,
            torch.rand(b, generator=g, device="cuda"),
            (torch.arange(b, device="cuda") >= b // 2).float())
    takes = GroupNorm._takes_kernel
    outs = {}

    def run():
        with torch.inference_mode(), precast_params(model):
            return model(*args)

    def timed(path):
        GroupNorm._takes_kernel = takes if path == "kernel" else \
            (lambda self, x: False)
        try:
            outs[path] = run().float()
            torch.cuda.synchronize()
            times = []
            for _ in range(best_of):
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            return min(times)
        finally:
            GroupNorm._takes_kernel = takes

    # profiled first: the profiler drops device events once a process has
    # kept the card busy for a while (chip_smoke.fresh_kernel_counts)
    for path in ("plain", "kernel"):
        GroupNorm._takes_kernel = takes if path == "kernel" else \
            (lambda self, x: False)
        try:
            per_kernel, busy, wall = cs.kernel_breakdown(run)
        finally:
            GroupNorm._takes_kernel = takes
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]
        out(kind="forward_profile", path=path, busy_ms=busy, wall_ms=wall,
            top=[[k[:90], v] for k, v in top])
    ms = {path: [] for path in ("plain", "kernel")}
    for path in ("plain", "kernel", "kernel", "plain"):
        ms[path].append(timed(path))
    rel = ((outs["kernel"] - outs["plain"]).norm()
           / outs["plain"].norm()).item()
    out(kind="forward", batch=b, best_of=best_of, ms=ms,
        speedup=min(ms["plain"]) / min(ms["kernel"]),
        rel_l2_kernel_vs_plain=rel)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sites", action="store_true")
    ap.add_argument("--forward", type=int, default=0)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("group_norm_probe: CUDA is not available", file=sys.stderr)
        return 2
    from diffusionmodel_tpu_torch.kernels import _build

    out = _Out(a.out)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out(kind="card", nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda)
    report = _build.build(["group_norm"])["group_norm"]
    out(kind="build", seconds=report["seconds"], ptxas=[
        ln.strip() for ln in report["log"].splitlines()
        if "registers" in ln or "spill" in ln])
    cs = _chip_smoke()
    if a.sites:
        sites(cs, out)
    if a.forward:
        forward(cs, out, a.forward)
    return 0


if __name__ == "__main__":
    sys.exit(main())
