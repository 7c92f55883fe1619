#!/usr/bin/env python3
"""Time the CoordAttn kernel at ``chip_smoke.py``'s four flagship sites,
under both norm kinds, and hold it against its plain twin, on one card.

    python3 tools/coord_attn_probe.py [--repo PATH] [--check] [--forward]
                                      [--out FILE]

``--repo PATH`` imports the port from another checkout (an earlier design
unpacked with ``git archive``), which builds its own kernel source in its
own ``kernels/build/``: run the probe once per checkout, in turns (earlier,
new, new, earlier), to compare two designs on one card. Each site prints
one JSON line (``chip_smoke.ca_site_row``): max |kernel - twin|, the
CUDA-event ms of back-to-back wrapper calls, the profiler's device ms per
kernel and their sum, the CoordAttn kernels launched per call, the bound
(x read once and out written once) and the floor of a design that reads x
twice, and the shares of both. ``--check`` first runs the ragged shapes
and the determinism checks (bit-identical reruns, a sample alone and
batched), and exits 1 if any fails. ``--forward`` then times the flagship
ContextUnet forward (batch 16, through the kernels) by CUDA events, three
calls. Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
RAGGED = [(3, 20, 20, 96), (2, 9, 9, 80), (2, 1, 1, 64), (1, 256, 256, 64),
          (2, 33, 33, 40), (2, 20, 20, 400)]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", type=Path, default=ROOT)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--forward", action="store_true")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("coord_attn_probe: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.repo.resolve()))
    cs = _chip_smoke()
    from diffusionmodel_tpu_torch.kernels.coord_attn import (
        coord_attn,
        coord_attn_plain,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = open(args.out, "a") if args.out else None

    def emit(**kv):
        line = json.dumps({"repo": str(args.repo), **kv})
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    emit(nvidia_smi=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    failed = []
    if args.check:
        with torch.no_grad():
            for shape in RAGGED:
                for kind in ("group", "affine"):
                    c = shape[-1]
                    wts, groups = cs.ca_site_weights(0, c, kind)
                    x = torch.randn(shape, device="cuda")
                    got = coord_attn(x, wts, kind, groups)
                    err = (got - coord_attn_plain(x, wts, kind, groups)
                           ).abs().max().item()
                    same = torch.equal(coord_attn(x, wts, kind, groups), got)
                    alone = torch.equal(coord_attn(
                        x[-1:].contiguous(), wts, kind, groups), got[-1:])
                    emit(check=list(shape), norm_kind=kind, max_abs_err=err,
                         rerun_identical=same, alone_identical=alone)
                    if not (err <= cs.KERNEL_ATOL and same and alone):
                        failed.append((shape, kind))
    for kind in ("group", "affine"):
        for i, (h, c) in enumerate(cs.CA_SITES):
            wts, groups = cs.ca_site_weights(i, c, kind)
            x = cs._site_x(cs.BATCH, h, c, 10 + i)
            row = cs.ca_site_row(x, wts, kind, groups, iters=50)
            emit(site=i + 1, **row)
            if row["max_abs_err"] > cs.KERNEL_ATOL:
                failed.append((row["shape"], kind))
            del x
    if args.forward:
        cfg, model = cs._flagship(True)
        g = torch.Generator(device="cuda").manual_seed(1)
        x = torch.randn((cs.BATCH, 256, 256, 3), generator=g, device="cuda")
        c = torch.arange(cs.BATCH, device="cuda") % cfg.model.n_classes
        t = torch.rand(cs.BATCH, generator=g, device="cuda")
        ctx = (torch.arange(cs.BATCH, device="cuda") >= cs.BATCH // 2).float()
        with torch.no_grad():
            ms = [cs.cuda_ms(lambda: model(x, c, t, ctx), 1)
                  for _ in range(3)]
        emit(forward_ms=ms)
    if out:
        out.close()
    if failed:
        print(f"coord_attn_probe: failed {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
