"""What every run shares: the benchmark's files found by name, the cache
directories, the import guard and the result line.

Nothing here names a cell, a configuration or a metric. A cell of
``BENCHMARK.json`` points at:

- its configuration's file (``configs[].file``), whose ``family`` names
  ``bench_gpu/families/<family>.py`` (the program's builder) and the plain
  reference beside it;
- its traffic, ``bench_gpu/workloads/<traffic>.json``, whose ``driver``
  names ``bench_gpu/drivers/<driver>.py``;
- its correctness limits, ``bench_gpu/limits/<cell>.json``;
- and each metric's reader, ``bench_gpu/metrics/<metric>.py``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
CACHE = ROOT / ".bench_cache"
# top-level module names the run may not hold once the window has closed
BANNED = ("jax", "jaxlib", "flax", "optax", "diffusionmodel_tpu")


class SpecError(RuntimeError):
    """The benchmark's files are missing or do not fit together."""


def prepare_env() -> None:
    """Fixed cache directories inside the checkout (so only a checkout's
    first run builds), and no JAX behind a library the port may load."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_json(path: Path) -> Dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError as e:
        raise SpecError(f"missing {path.relative_to(ROOT)}") from e


def load_spec() -> Dict:
    return load_json(ROOT / "BENCHMARK.json")


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict
    metrics: List[Dict] = field(default_factory=list)


def find_cell(spec: Dict, name: str, trace: bool) -> Cell:
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg = load_json(ROOT / configs[w["config"]]["file"])
    traffic = load_json(HERE / "workloads" / f"{w['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{name}.json")
    return Cell(name, int(w["chips"]), cfg, traffic, limits,
                metrics_for(spec, name, trace))


def metrics_for(spec: Dict, cell: str, trace: bool) -> List[Dict]:
    """The cell's end-to-end metrics (``trace`` false) or per-layer ones:
    those that list the cell, or, without a list, every cell that reports
    the metric each moves."""
    e2e = [m for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in mine)]


def _load_file(path: Path, modname: str):
    if not path.exists():
        raise SpecError(f"missing {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The reader module of ``metric`` (``bench_gpu/metrics/<name>.py``)."""
    safe = "".join(ch if ch.isalnum() else "_" for ch in metric)
    return _load_file(HERE / "metrics" / f"{metric}.py",
                      f"bench_gpu_metric_{safe}")


def driver(cell: Cell):
    name = cell.traffic["driver"]
    return importlib.import_module(f"bench_gpu.drivers.{name}")


def family(cfg: Dict):
    return importlib.import_module(f"bench_gpu.families.{cfg['family']}")


def banned_loaded() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in BANNED)


def read_metrics(cell: Cell, rec: Dict) -> Dict:
    """Each metric's reading of the run's record; a reader that finds
    nothing to read returns None and the metric is left out."""
    out = {}
    for m in cell.metrics:
        v = reader(m["name"]).read(rec)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def check_lines(checks: List[Dict]) -> List[str]:
    return [f"check {c['name']}: {c['value']!r} limit {c['limit']!r} "
            f"({'ok' if c['ok'] else 'FAILS'})" for c in checks]


def result_line(correct: bool, attempted: int, failed: int, metrics: Dict,
                device: Dict, checks: List[Dict],
                breakdown: Optional[Dict] = None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in checks}
    return json.dumps(out)
