"""Closed-loop clients of the port's ``SamplerService``.

Traffic parameters (``bench_gpu/workloads/<traffic>.json``): ``clients``
threads, each sending its next request only when the last one returned
(``traffic.serve_requests``: images per request, classes, guidance, a
pinned seed on ``pinned_share`` of them); the service's ``sampler``,
``max_batch`` and ``max_wait_ms``; ``program``: dotted config keys set on
the port (the sampler's depth); ``warm_batches`` full slot batches in
set-up; ``trace_seconds`` of profiled load at the window's start in a
traced run.

The window opens when the clients start and closes when the last request
sent before ``--seconds`` has returned. Every request's latency runs from
its ``submit`` to its result.

Correctness: once the window has closed and the program is freed, a sample
drawn from the seed of the pinned requests that finished (their start
noise is a function of their seed, so the reference can work it out
again) is generated again by the plain float32 reference with the same
sampler. Each image's relative L2 distance from it is read against the
distance of the same request generated by the reference with its
products rounded to the configuration's precision (``limits: baseline``),
and the largest ratio is compared: the raw distance grows with the
guidance scale (the sampler multiplies an eps error by about 1 + 2w) and
with each seed's weights, three times over across seeds at one scale, so
no limit on it separated the program from the control (PERF.md).
"""

from __future__ import annotations

import gc
from typing import Dict, List, Optional

import numpy as np
import torch

from bench_gpu import harness, loops, traffic
from bench_gpu.checks import limit_checks
from bench_gpu.reference import diffusion as refdiff
from bench_gpu.reference import lowp
from bench_gpu.reference.context_unet import set_quant
from bench_gpu.weights import derive


class Session:
    def __init__(self, cell: harness.Cell, seed: int, device):
        from diffusionmodel_tpu_torch.serving import SamplerService

        self.cell, self.seed, self.dev = cell, seed, device
        self.tr = tr = cell.traffic
        self.fam = harness.family(cell.config)
        self.pc, self.model, self.sched = self.fam.build_program(
            cell.config, seed, device, tr.get("program"))
        self.svc = SamplerService(
            self.model, self.pc, self.sched, max_batch=tr["max_batch"],
            sampler=tr["sampler"], max_wait_ms=tr["max_wait_ms"],
            service_seed=derive(seed, 2))
        self.results: List[Dict] = []

    def warm(self) -> None:
        """Full slot batches of the one shape the service runs (its first
        pays the kernels' build, cuDNN's search and the packing)."""
        for w in range(self.tr["warm_batches"]):
            futs = [self.svc.submit([i % self.pc.model.n_classes], 4.0,
                                    seed=derive(self.seed, 9, w, i))
                    for i in range(self.tr["max_batch"])]
            for f in futs:
                f.result()

    def window(self, seconds: float, tracer=None) -> Dict:
        tr = self.tr
        before = dict(self.svc.stats)
        streams = [traffic.serve_requests(tr, self.seed, i)
                   for i in range(tr["clients"])]
        self.results, window_s = loops.closed_loop(
            streams, lambda r: self.svc.submit(r["classes"], r["guide_w"],
                                               r["seed"]).result(),
            seconds, tracer, tr["trace_seconds"])
        after = dict(self.svc.stats)
        ok = [r for r in self.results if r["ok"]]
        steps = self.pc.sample.dpm_steps if tr["sampler"] == "dpmpp" \
            else self.pc.sample.ddim_steps
        cfg = self.cell.config
        return {
            "window_s": window_s,
            "images": sum(len(r["classes"]) for r in ok),
            "latencies": [r["t1"] - r["t0"] for r in ok],
            "stats": {k: after[k] - before[k] for k in before},
            "trace": None if tracer is None else tracer.finish(),
            "dtype": cfg["model"]["dtype"],
            # guidance doubles the rows of every step
            "flops_per_image": 2 * steps * self.fam.forward_flops(cfg, 1),
            "sites": self.fam.sites(cfg, 2 * tr["max_batch"]),
        }

    def free(self) -> None:
        self.svc.close()
        del self.svc, self.model
        gc.collect()
        torch.cuda.empty_cache()

    def sample(self) -> List[Dict]:
        """The pinned requests the check compares, drawn from the seed."""
        pinned = [r for r in self.results if r["ok"] and r["seed"] is not None]
        rng = np.random.default_rng(derive(self.seed, 5))
        k = min(len(pinned), self.cell.limits["requests"])
        return [pinned[i] for i in sorted(rng.choice(len(pinned), k,
                                                     replace=False))]

    def reference_images(self, reqs: List[Dict],
                         quant: Optional[str] = None) -> np.ndarray:
        """The requests' images from the plain reference, in one batch;
        ``quant`` rounds its products (``lowp.QUANTS``: the baseline or a
        control)."""
        cfg = self.cell.config
        m, dc = cfg["model"], cfg["diffusion"]
        net = self.fam.build_reference(cfg, self.seed, self.dev).eval()
        set_quant(net, lowp.QUANTS[quant] if quant else None)
        sch = refdiff.schedule(dc["beta1"], dc["beta2"], dc["n_T"], self.dev)
        x = np.concatenate([refdiff.start_noise(r["seed"], len(r["classes"]),
                                                m["img_size"], m["in_ch"])
                            for r in reqs])
        classes = torch.tensor([c for r in reqs for c in r["classes"]],
                               device=self.dev)
        guide = torch.tensor([r["guide_w"] for r in reqs
                              for _ in r["classes"]], device=self.dev)
        steps = self.pc.sample.dpm_steps
        with lowp.tf32_allowed(False):
            cudnn = torch.backends.cudnn
            bench, cudnn.benchmark = cudnn.benchmark, False
            try:
                out = refdiff.sample_dpmpp(
                    net, torch.from_numpy(x).to(self.dev), classes, guide,
                    sch["abar64"], dc["n_T"], steps)
            finally:
                cudnn.benchmark = bench
        del net
        return out.cpu().numpy()

    def check(self, controls: bool = False) -> Dict:
        """Frees the program, then compares. Returns the checks, the
        requests attempted and failed, the per-request distances, and with
        ``controls`` the same number read from each control in the
        program's place."""
        lim = self.cell.limits
        reqs = self.sample()
        failed = sum(1 for r in self.results if not r["ok"])
        errors = [r["out"] for r in self.results if not r["ok"]][:3]
        self.free()
        out = {"attempted": len(self.results), "failed": failed,
               "errors": errors, "checks": []}
        if not reqs:
            out["checks"].append({"name": "requests_compared", "value": 0,
                                  "limit": 1, "ok": False})
            return out
        want = self.reference_images(reqs)
        got = np.concatenate([r["out"] for r in reqs])
        base = image_gaps(self.reference_images(reqs, lim["baseline"]), want)
        gaps = image_gaps(got, want)
        out["checks"] = limit_checks(
            {"image_gap_over_baseline": worst_ratio(gaps, base)},
            lim["compared"])
        out["compared"] = len(reqs)
        out["per_request"] = {"guide_w": [r["guide_w"] for r in reqs],
                              "program": gaps.tolist(),
                              "baseline": base.tolist()}
        if controls:
            low = {q: image_gaps(self.reference_images(reqs, q), want)
                   for q in lim["controls"]}
            out["control"] = {q: {"image_gap_over_baseline":
                                  worst_ratio(v, base)}
                              for q, v in low.items()}
            out["per_request"].update({q: v.tolist() for q, v in low.items()})
        return out


def worst_ratio(gaps: np.ndarray, base: np.ndarray) -> float:
    """The largest ratio of a request's distance from the reference to the
    baseline's distance for the same request (inf if any is not finite)."""
    r = gaps / np.maximum(base, 1e-30)
    return float(r.max()) if np.isfinite(r).all() else float("inf")


def image_gaps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Each image's relative L2 distance from its reference."""
    d = (got - want).reshape(len(got), -1)
    w = want.reshape(len(want), -1)
    return np.linalg.norm(d, axis=1) / np.maximum(np.linalg.norm(w, axis=1),
                                                  1e-30)


def image_gap(got: np.ndarray, want: np.ndarray) -> float:
    """The largest relative L2 distance of an image from its reference."""
    return float(np.max(image_gaps(got, want)))
