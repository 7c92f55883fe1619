#!/usr/bin/env python3
"""Time the SE kernel at ``chip_smoke.py``'s five flagship sites, in fp32
and bf16, and hold it against its plain twin, on one card.

    python3 tools/se_probe.py [--repo PATH] [--check] [--iters N]
                              [--rotate-mb MB] [--out FILE]

``--repo PATH`` imports the port from another checkout (an earlier design
unpacked with ``git archive``), which builds its own kernel source in its
own ``kernels/build/``: run the probe once per checkout, in turns (earlier,
new, new, earlier), to compare two designs on one card. Each design gets
its weights in the layout it reads without a copy: the transposed views of
``nn.Linear`` weights where the module has ``launch_plan`` (this design),
contiguous [C, R] and [R, C] otherwise.

Each site is timed over rotating copies of x whose total is at least
``--rotate-mb`` (200 MB): a call never finds its x in the 50 MB L2 from the
call before. A site prints one JSON line: max |kernel - twin| (fp32) or
relative L2 and max |diff| (bf16), the CUDA-event ms per call, the CUDA
kernels launched per call (torch.profiler), the bytes bound (x read once,
out written once, the weights once), the design's bound where the module
has a launch plan (plus the bytes it re-reads), and the shares of both.
``--check`` first runs ragged shapes in fp32 and bf16 against the twin,
bit-identical reruns, ``x[k:k+1]`` against row k of batches of 5 and 16,
and shapes alternated on one stream; it exits 1 if any fails. Prints the
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
# ragged: pixels off the tiles, C off the 128-byte rows, B = 1, 5 and 16
RAGGED = [(3, 5, 7, 24), (1, 1, 1, 8), (5, 37, 29, 64), (2, 33, 17, 200),
          (16, 23, 23, 48), (2, 96, 96, 1040), (1, 130, 130, 192)]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def weights(c: int, r: int, seed: int, linear_layout: bool):
    """w1 [C, R] and w2 [R, C] drawn as ``chip_smoke.py`` draws them; with
    ``linear_layout`` as transposed views of contiguous [R, C] and [C, R]
    tensors (``SEBlock``'s ``fc[0].weight.t()``, ``fc[2].weight.t()``)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    w1 = torch.randn((c, r), generator=g, device="cuda") / c ** 0.5
    w2 = torch.randn((r, c), generator=g, device="cuda") / r ** 0.5
    if linear_layout:
        return w1.t().contiguous().t(), w2.t().contiguous().t()
    return w1, w2


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", type=Path, default=ROOT)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--rotate-mb", type=float, default=200.0)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("se_probe: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.repo.resolve()))
    cs = _chip_smoke()
    from diffusionmodel_tpu_torch.kernels import _build
    from diffusionmodel_tpu_torch.kernels import se_block as mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = open(args.out, "a") if args.out else None
    plan_of = getattr(mod, "launch_plan", None)

    def emit(**kv):
        line = json.dumps({"repo": str(args.repo), **kv})
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    emit(nvidia_smi=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    report = _build.build(["se_block"])["se_block"]
    emit(build_seconds=report["seconds"], ptxas=[
        line.strip() for line in report["log"].splitlines()
        if "registers" in line or "spill" in line or "Compiling" in line])
    failed = []

    def close(got, want) -> dict:
        got, want = got.float(), want.float()
        d = (got - want).abs().max().item()
        return dict(max_abs_err=d, max_abs_out=want.abs().max().item(),
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
                for i, shape in enumerate(RAGGED):
                    c = shape[-1]
                    w1, w2 = weights(c, max(1, c // 16), 40 + i,
                                     plan_of is not None)
                    x = torch.randn(shape, device="cuda").to(dtype)
                    got = mod.se_block(x, w1, w2)
                    row = close(got, mod.se_block_plain(x, w1, w2))
                    row["rerun_identical"] = torch.equal(
                        mod.se_block(x, w1, w2), got)
                    row["alone_identical"] = all(torch.equal(
                        mod.se_block(x[k:k + 1].contiguous(), w1, w2),
                        got[k:k + 1]) for k in {0, shape[0] // 2,
                                                shape[0] - 1})
                    emit(check=list(shape), dtype=str(dtype), **row)
                    if not (ok(row, dtype) and row["rerun_identical"]
                            and row["alone_identical"]):
                        failed.append((shape, str(dtype)))
            # batches of 5 and 16 at two flagship sites: each row alone
            for h, c in ((32, 1536), (64, 768)):
                for bsz in (5, 16):
                    w1, w2 = weights(c, c // 16, 7, plan_of is not None)
                    x = torch.randn((bsz, h, h, c), device="cuda"
                                    ).to(torch.bfloat16)
                    got = mod.se_block(x, w1, w2)
                    same = all(torch.equal(mod.se_block(
                        x[k:k + 1].contiguous(), w1, w2), got[k:k + 1])
                        for k in range(bsz))
                    emit(check=[bsz, h, h, c], dtype="torch.bfloat16",
                         rows_alone_identical=same)
                    if not same:
                        failed.append(((bsz, h, h, c), "rows"))
            # shapes of other plans in turn on one stream (a counter or flag
            # left behind would show as a hang or a wrong gate)
            cases = []
            for i, (shape, dtype) in enumerate(
                    (((2, 32, 32, 1536), torch.bfloat16),
                     ((5, 64, 64, 768), torch.float32),
                     ((3, 20, 20, 96), torch.bfloat16),
                     ((16, 16, 16, 192), torch.float32))):
                c = shape[-1]
                w1, w2 = weights(c, c // 16, 60 + i, plan_of is not None)
                x = torch.randn(shape, device="cuda").to(dtype)
                cases.append((x, w1, w2, mod.se_block_plain(x, w1, w2)))
            for _ in range(3):
                for x, w1, w2, want in cases:
                    row = close(mod.se_block(x, w1, w2), want)
                    if not ok(row, x.dtype):
                        failed.append((tuple(x.shape), "in turn"))
            torch.cuda.synchronize()
            emit(check="shapes in turn", failed=len(failed))

    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            totals = {"ms": 0.0, "bound_ms": 0.0, "design_bound_ms": 0.0}
            for i, (h, c) in enumerate(cs.SE_SITES):
                r = c // 16
                x = cs._site_x(cs.BATCH, h, c, i).to(dtype)
                w1, w2 = weights(c, r, 100 + i, plan_of is not None)
                row = close(mod.se_block(x, w1, w2),
                            mod.se_block_plain(x, w1, w2))
                cs.ROTATE_BYTES = args.rotate_mb * 1e6
                ms, n_copies = cs.rotating_ms(
                    lambda a: mod.se_block(a, w1, w2), x, args.iters)
                kernels = cs.kernel_launches(lambda: mod.se_block(x, w1, w2))
                nbytes = 2 * x.numel() * x.element_size() + 2 * c * r * 4
                b_ms = nbytes / cs.HBM_BYTES_PER_S * 1e3
                row.update(site=i + 1, shape=list(x.shape), dtype=str(dtype),
                           ms=ms, copies=n_copies, kernels=kernels,
                           kernels_per_call=sum(kernels.values()),
                           bound_ms=b_ms, bound_share=b_ms / ms)
                if plan_of is not None:
                    plan = plan_of(*x.shape, r, dtype)
                    d_ms = (plan.bytes_read + plan.bytes_reread
                            + plan.bytes_written) / cs.HBM_BYTES_PER_S * 1e3
                    row.update(design_bound_ms=d_ms,
                               bytes_reread=plan.bytes_reread,
                               design_bound_share=d_ms / ms,
                               parts=plan.parts,
                               tiles_per_part=plan.tiles_per_part)
                    totals["design_bound_ms"] += d_ms
                totals["ms"] += ms
                totals["bound_ms"] += b_ms
                emit(**row)
                if not ok(row, dtype):
                    failed.append((row["shape"], str(dtype)))
                del x
                torch.cuda.empty_cache()
            emit(dtype=str(dtype), per_forward=totals,
                 bound_share=totals["bound_ms"] / totals["ms"])
    if out:
        out.close()
    if failed:
        print(f"se_probe: failed {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
