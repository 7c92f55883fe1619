#!/usr/bin/env python3
"""Time the CoordAttn kernel at ``chip_smoke.py``'s four flagship sites,
in fp32 (both norm kinds) and bf16, and hold it against the plain twin,
on one card.

    python3 tools/coord_attn_probe.py [--repo PATH] [--check] [--forward]
                                      [--out FILE]

At each site the probe times the kernel twice back to back and prints one
JSON line with both runs. ``--repo PATH`` imports the port
from another checkout (an earlier design unpacked with ``git archive``),
which builds its own kernel sources in its own ``kernels/build/``, and
times that: run the probe once per checkout, in turns (earlier, new, new,
earlier), to compare two checkouts on one card.

Each call is timed over rotating copies of x whose total is at least
``chip_smoke.ROTATE_BYTES`` (200 MB): a call never finds its x in the 50 MB L2 from the
call before. A line gives max |kernel - twin| (fp32) or relative L2 and
max |diff| (bf16), the CUDA-event ms per call (``chip_smoke.ca_timing``),
the CUDA kernels one call launches (torch.profiler), the bytes bound (x
read once, out written once, the weights once), the three launches' floor
(x read twice, out written once), and the shares of both. ``--check``
first runs ragged shapes in fp32 and bf16 against the twin (a 256 px one
among them), bit-identical reruns, ``x[k:k+1]`` against row k of a batch
of 16, and shapes alternated on one stream; it exits 1 if any fails.
``--forward`` then times the flagship ContextUnet forward (batch 16,
through the model's kernels) by CUDA events, three calls. Prints the
card's name and power limit first.
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
# ragged: L off the row tiles, C off the 32-channel chunks, L = 1, 256 px
RAGGED = [(3, 20, 20, 96), (2, 9, 9, 80), (2, 1, 1, 64), (1, 256, 256, 64),
          (2, 33, 33, 40), (2, 20, 20, 400), (1, 256, 256, 128)]


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
    from diffusionmodel_tpu_torch.kernels import _build
    from diffusionmodel_tpu_torch.kernels.coord_attn import (
        coord_attn as run,
        coord_attn_plain as twin,
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
    report = _build.build(["coord_attn"])["coord_attn"]
    emit(build_seconds=report["seconds"],
         ptxas=[line.strip() for line in report["log"].splitlines()
                if "registers" in line or "spill" in line])
    failed = []

    def close(got, want) -> dict:
        got, want = got.float(), want.float()
        return dict(max_abs_err=(got - want).abs().max().item(),
                    max_abs_out=want.abs().max().item(),
                    rel_l2=((got - want).norm() / want.norm().clamp_min(
                        1e-30)).item())

    def ok(row, dtype) -> bool:
        if dtype == torch.float32:
            return row["max_abs_err"] <= cs.KERNEL_ATOL
        return (row["rel_l2"] <= cs.BF16_REL_L2 and row["max_abs_err"]
                <= cs.BF16_MAX_REL * row["max_abs_out"])

    if args.check:
        with torch.no_grad():
            for dtype in (torch.float32, torch.bfloat16):
                for shape in RAGGED:
                    for kind in ("group", "affine"):
                        c = shape[-1]
                        if c % (16 // dtype.itemsize):
                            continue
                        wts, groups = cs.ca_site_weights(0, c, kind)
                        x = torch.randn(shape, device="cuda").to(dtype)
                        got = run(x, wts, kind, groups)
                        row = close(got, twin(x, wts, kind, groups))
                        row["rerun_identical"] = torch.equal(
                            run(x, wts, kind, groups), got)
                        row["alone_identical"] = torch.equal(run(
                            x[-1:].contiguous(), wts, kind, groups), got[-1:])
                        emit(check=list(shape), dtype=str(dtype),
                             norm_kind=kind, **row)
                        if not (ok(row, dtype) and row["rerun_identical"]
                                and row["alone_identical"]):
                            failed.append((shape, str(dtype), kind))
            # a batch of 16 at the deepest and the widest site: each row alone
            for i in (3, 0):
                h, c = cs.CA_SITES[i]
                wts, groups = cs.ca_site_weights(i, c, "group")
                x = cs._site_x(16, h, c, 10 + i).bfloat16()
                got = run(x, wts, "group", groups)
                same = all(torch.equal(run(x[k:k + 1].contiguous(), wts,
                                           "group", groups), got[k:k + 1])
                           for k in range(16))
                emit(check=[16, h, h, c], dtype="torch.bfloat16",
                     rows_alone_identical=same)
                if not same:
                    failed.append(((16, h, h, c), "rows"))
            # shapes of other plans in turn on one stream (a counter left
            # behind would show as a wrong gate or a hang)
            cases = []
            for i, (shape, dtype, kind) in enumerate((
                    ((2, 16, 16, 1536), torch.bfloat16, "group"),
                    ((5, 64, 64, 384), torch.float32, "affine"),
                    ((3, 20, 20, 96), torch.bfloat16, "group"),
                    ((16, 32, 32, 768), torch.float32, "group"))):
                wts, groups = cs.ca_site_weights(i, shape[-1], kind)
                x = torch.randn(shape, device="cuda").to(dtype)
                cases.append((x, wts, kind, groups,
                              twin(x, wts, kind, groups)))
            for _ in range(3):
                for x, wts, kind, groups, want in cases:
                    if not ok(close(run(x, wts, kind, groups), want),
                              x.dtype):
                        failed.append((tuple(x.shape), "in turn"))
            torch.cuda.synchronize()
            emit(check="shapes in turn", failed=len(failed))

    with torch.no_grad():
        for dtype, kinds in ((torch.float32, ("group", "affine")),
                             (torch.bfloat16, ("group",))):
            for kind in kinds:
                total = bound_total = 0.0
                for i, (h, c) in enumerate(cs.CA_SITES):
                    wts, groups = cs.ca_site_weights(i, c, kind)
                    x = cs._site_x(cs.BATCH, h, c, 10 + i).to(dtype)
                    runs = [cs.ca_timing(x, wts, kind, groups)
                            for _ in range(2)]
                    row = close(run(x, wts, kind, groups),
                                twin(x, wts, kind, groups))
                    row.update(runs[0])
                    ms = [r["ms"] for r in runs]
                    row.update(ms=sum(ms) / len(ms), ms_runs=ms)
                    row["bound_share"] = row["bound_ms"] / row["ms"]
                    row["design_bound_share"] = (row["design_bound_ms"]
                                                 / row["ms"])
                    kernels = cs.kernel_launches(
                        lambda: run(x, wts, kind, groups))
                    row.update(site=i + 1, norm_kind=kind, kernels=kernels,
                               kernels_per_call=sum(
                                   n for k, n in kernels.items()
                                   if k.startswith("ca_")))
                    total += row["ms"]
                    bound_total += row["bound_ms"]
                    emit(**row)
                    if not ok(row, dtype):
                        failed.append((row["shape"], str(dtype), kind))
                    del x
                    torch.cuda.empty_cache()
                emit(dtype=str(dtype), norm_kind=kind, per_forward=total,
                     bound_ms=bound_total, bound_share=bound_total / total)
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
