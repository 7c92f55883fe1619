#!/usr/bin/env python3
"""Time variants of the flash-attention forward kernel against each other
on one card.

    python3 tools/flash_fwd_probe.py [--baseline PATH] [--out FILE] TILES...

Each TILES argument is one row of ``csrc/flash_attn.cu``'s
``FLASH_FWD_TILES`` table, ``D,C,W,MT,MINB`` (for example
``40,64,4,2,1``): a copy of the source whose table is that one row is
built into a library of its own; ``default`` builds the source with its
own table, and
``--baseline PATH`` adds another forward source with the same C interface
(an earlier design), built as it is. All builds run in parallel. Every
library runs at ``chip_smoke.py``'s flash sites (and its training site)
for its head dims: max |diff| of o and L against the plain twin, and
device time by CUDA events, taken in turns (variants in order, then in
reverse) beside fp32 ``scaled_dot_product_attention``. Prints one JSON
line per build (ptxas registers and spill bytes) and per site.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from diffusionmodel_tpu_torch.kernels import _build  # noqa: E402
from diffusionmodel_tpu_torch.kernels.flash_attn import (  # noqa: E402
    HEAD_DIMS,
    flash_attention_plain,
)


def _start(label: str, source: Path, row: str, tmp: Path):
    if row:
        table = f"#define FLASH_FWD_TILES(X) X({row})\n"
        text, hits = re.subn(r"#define FLASH_FWD_TILES\(X\)(?:[^\n]*\\\n)*"
                             r"[^\n]*\n", lambda _: table, source.read_text())
        if hits != 1:
            raise RuntimeError(f"{source}: no FLASH_FWD_TILES table")
        source = tmp / f"{label}.cu"
        source.write_text(text)
    lib = tmp / f"lib{label}.so"
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
           str(lib), str(source)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attn_forward.argtypes = [p] * 5 + [i] * 5 + [ll] * 8 + [p]
    lib.flash_attn_forward.restype = ctypes.c_int
    return lib


def _call(lib, q, k, v, want_lse):
    b, n, h, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, n), device=q.device) if want_lse else None
    err = lib.flash_attn_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr() if want_lse else None, b, h, n, k.shape[1], d,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
        v.stride(1), o.stride(0), o.stride(1),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attn_forward: CUDA error {err}")
    return o, lse


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tiles", nargs="*", default=["default"])
    ap.add_argument("--baseline", type=Path, default=None)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_fwd_probe: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    out = open(args.out, "w") if args.out else None

    def emit(**kv):
        line = json.dumps(kv)
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    src = _build.CSRC / "flash_attn.cu"
    builds = [(row, src, "" if row == "default" else row)
              for row in args.tiles]
    if args.baseline:
        builds.append(("baseline", args.baseline, ""))
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for i, (label, source, row) in enumerate(builds):
            procs[label] = _start(f"v{i}", source, row, Path(tmp))
        libs, dims = {}, {}
        for label, (path, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"{label}: nvcc failed\n{log}")
            regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
            spills = [int(x) for x in
                      re.findall(r"(\d+) bytes spill stores", log)]
            emit(build=label, registers=regs, spill_store_bytes=spills)
            libs[label] = _load(path)
            dims[label] = (HEAD_DIMS if "," not in label
                           else (int(label.split(",")[0]),))
        sites = [(s, False) for s in chip_smoke.FLASH_SITES] + [
            (chip_smoke.FLASH_TRAIN, True)]
        for i, ((b, n, m, h, d), want_lse) in enumerate(sites):
            names = [lb for lb in libs if d in dims[lb]]
            if not names:
                continue
            g = torch.Generator(device="cuda").manual_seed(500 + i)
            q = torch.randn((b, n, h, d), generator=g, device="cuda")
            k = torch.randn((b, m, h, d), generator=g, device="cuda")
            v = torch.randn((b, m, h, d), generator=g, device="cuda")
            ref_o, ref_lse = flash_attention_plain(q, k, v, want_lse=True)
            rows = {}
            for lb in names:
                o, lse = _call(libs[lb], q, k, v, True)
                rows[lb] = {"max_abs_err": (o - ref_o).abs().max().item(),
                            "max_abs_err_lse":
                                (lse - ref_lse).abs().max().item(),
                            "ms": []}
            del ref_o, ref_lse
            iters = 10 if b * n * m * h * d >= 2 ** 32 else 5
            for lb in names + names[::-1]:
                rows[lb]["ms"].append(chip_smoke.cuda_ms(
                    lambda: _call(libs[lb], q, k, v, want_lse), iters))
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            sdpa = chip_smoke.cuda_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt), iters)
            nbytes = 4 * (2 * b * n * h * d + 2 * b * m * h * d)
            flops = 4 * b * h * n * m * d
            emit(site=[b, n, m, h, d], want_lse=want_lse,
                 bound_ms=chip_smoke.bound_3xtf32(nbytes, flops)[0],
                 bound_ms_fp32=chip_smoke.bound(nbytes, flops)[0],
                 sdpa_ms=sdpa, variants=rows)
            del q, k, v, qt, kt, vt
            torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
