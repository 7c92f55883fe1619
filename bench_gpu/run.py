#!/usr/bin/env python3
"""One run of one benchmark cell of the PyTorch/CUDA port.

    python3 bench_gpu/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Sets up the cell from the seed (weights made on the device, traffic from
the seed), warms the shapes the cell uses, runs its load for ``--seconds``
(``--trace 1``: profiling a short sub-window at its start), checks what the
timed path produced against the plain reference, and prints one JSON line
as the last line of standard output:

    {"correct", "attempted", "failed", "metrics", "device"[, "breakdown"],
     "checks"}

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer ones. The numbers compared, each beside its limit, are also the
last lines of standard error. The run exits non-zero without a result when
no CUDA device (or too few) is present, when the benchmark's files are
missing, or when ``jax``, ``jaxlib``, ``flax``, ``optax`` or the JAX
package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench_gpu import harness  # noqa: E402


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card_report() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def guard(when: str) -> bool:
    bad = harness.banned_loaded()
    if bad:
        print(f"modules that the run may not load, {when}: {bad}",
              file=sys.stderr)
    return not bad


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool,
        device) -> int:
    """Everything after the look for a card: set-up, window, check,
    result. Returns the exit code."""
    import torch

    from bench_gpu.trace import Tracer

    cuda = device.type == "cuda"
    t0 = time.perf_counter()
    sess = harness.driver(cell).Session(cell, seed, device)
    sess.warm()
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    print(f"setup_s {setup_s!r}", file=sys.stderr)
    rec = sess.window(seconds, Tracer() if trace else None)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if not guard("once the window has closed"):
        return 4
    rec["setup_s"] = setup_s
    t1 = time.perf_counter()
    res = sess.check()
    print(f"check_s {time.perf_counter() - t1!r}", file=sys.stderr)
    if not guard("after the check"):
        return 4
    metrics = harness.read_metrics(cell, rec)
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace and rec.get("trace"):
        t = rec["trace"]
        dev["busy_s"], dev["window_s"] = t["busy_s"], t["window_s"]
        breakdown = {"device_ops": t["device_ops"],
                     "idle_gaps": t["idle_gaps"]}
    checks = res["checks"]
    correct = bool(checks) and all(c["ok"] for c in checks) \
        and res["failed"] == 0
    for err in res["errors"]:
        print(f"failed request: {err}", file=sys.stderr)
    for line in harness.check_lines(checks):
        print(line, file=sys.stderr)
    print(harness.result_line(correct, res["attempted"], res["failed"],
                              metrics, dev, checks, breakdown), flush=True)
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    harness.prepare_env()
    try:
        spec = harness.load_spec()
        cell = harness.find_cell(spec, args.workload, bool(args.trace))
    except harness.SpecError as e:
        print(f"benchmark files: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{n} present", file=sys.stderr)
        return 3
    print(card_report(), file=sys.stderr)
    return run(cell, args.seed, args.seconds, bool(args.trace),
               torch.device("cuda", 0))


if __name__ == "__main__":
    sys.exit(main())
