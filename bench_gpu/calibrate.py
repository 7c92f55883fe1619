#!/usr/bin/env python3
"""The readings a cell's correctness limits are set from (not run by the
benchmark's own runs).

    python3 bench_gpu/calibrate.py --workload <cell> --seeds 11,12,13 --seconds 20

For each seed, in one process: the cell's set-up, a window of
``--seconds`` at the cell's own load, then the check with its controls:
the numbers of the program against the reference, of each control (the
reference computed below the configuration's precision, in the program's
place) and of each planted fault (``--controls N``: on the first N seeds
only), one JSON line per seed. Each control's and fault's numbers are
held to the cell's limits as the program's are (``control_verdict``,
``fault_verdict``): each has to come out not correct. The limit of a
number lies above the program's largest reading over a dozen seeds and
below the smallest reading of the control or fault that fails it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench_gpu import harness  # noqa: E402
from bench_gpu.checks import verdict  # noqa: E402


def readings(cell: harness.Cell, seed: int, seconds: float, device,
             controls: bool = True) -> dict:
    t0 = time.perf_counter()
    sess = harness.driver(cell).Session(cell, seed, device)
    sess.warm()
    t1 = time.perf_counter()
    sess.window(seconds)
    t2 = time.perf_counter()
    res = sess.check(controls=controls)
    t3 = time.perf_counter()
    res.pop("errors", None)
    res["correct"] = bool(res["checks"]) and all(
        c["ok"] for c in res["checks"]) and res["failed"] == 0
    res["checks"] = {c["name"]: c["value"] for c in res["checks"]}
    limits = cell.limits["compared"]
    for kind in ("control", "fault"):
        if kind in res:
            res[f"{kind}_verdict"] = {q: verdict(g, limits)
                                      for q, g in res[kind].items()}
    return {"seed": seed, **res, "setup_s": t1 - t0, "window_s": t2 - t1,
            "check_s": t3 - t2}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--controls", type=int, default=None,
                   help="run the controls and faults on the first N seeds "
                   "only (default: all)")
    args = p.parse_args(argv)
    harness.prepare_env()
    import torch

    cell = harness.find_cell(harness.load_spec(), args.workload, False)
    for i, s in enumerate(args.seeds.split(",")):
        ctl = args.controls is None or i < args.controls
        print(json.dumps(readings(cell, int(s), args.seconds,
                                  torch.device("cuda", 0), ctl)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
