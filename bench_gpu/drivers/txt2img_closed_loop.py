"""Closed-loop callers of the port's ``LdmRunner.txt2img``.

Traffic parameters: ``callers`` threads, each calling again when its last
call returned, with ``batch`` images of ``size`` px a call, guidance
``scale``, the runner's ``sampler`` and ``steps``, a prompt drawn from
``prompts`` with the seed, and the start latents from a generator seeded
per call; ``warm_calls`` calls in set-up; ``trace_seconds``.

Correctness: once the window has closed and the program is freed, a
sample of the finished calls drawn from the seed (``limits: calls``) is
generated again by the plain float32 reference (UNet, DPM-Solver++,
VAE decoder) from the same prompt-hash context and start latents, and
each image is compared by its relative L2 distance.
"""

from __future__ import annotations

import gc
from typing import Dict, List

import numpy as np
import torch

from bench_gpu import harness, loops, traffic
from bench_gpu.checks import limit_checks
from bench_gpu.drivers.serve_closed_loop import image_gap
from bench_gpu.reference import latent_diffusion as ref
from bench_gpu.reference import lowp
from bench_gpu.weights import derive


class Session:
    def __init__(self, cell: harness.Cell, seed: int, device):
        self.cell, self.seed, self.dev = cell, seed, device
        self.tr = tr = cell.traffic
        self.fam = harness.family(cell.config)
        self.runner = self.fam.build_program(cell.config, seed, device,
                                             tr["sampler"], tr["steps"])
        self.results: List[Dict] = []

    def _call(self, prompt: str, gseed: int) -> np.ndarray:
        tr = self.tr
        g = torch.Generator(device=self.dev).manual_seed(gseed)
        return self.runner.txt2img(prompt, batch_size=tr["batch"],
                                   h=tr["size"], w=tr["size"],
                                   uncond_scale=tr["scale"], generator=g)

    def warm(self) -> None:
        for w in range(self.tr["warm_calls"]):
            self._call(self.tr["prompts"][0], derive(self.seed, 16, w))

    def window(self, seconds: float, tracer=None) -> Dict:
        tr = self.tr
        streams = [traffic.prompt_calls(tr, self.seed, i)
                   for i in range(tr["callers"])]
        self.results, window_s = loops.closed_loop(
            streams, lambda c: self._call(c["prompt"], c["seed"]), seconds,
            tracer, tr["trace_seconds"])
        ok = [r for r in self.results if r["ok"]]
        cfg = self.cell.config
        per_image = (2 * tr["steps"] * self.fam.unet_flops(cfg, 1)
                     + self.fam.decode_flops(cfg, 1))
        return {
            "window_s": window_s,
            "images": tr["batch"] * len(ok),
            "latencies": [r["t1"] - r["t0"] for r in ok],
            "trace": None if tracer is None else tracer.finish(),
            "dtype": cfg["dtype"],
            # guidance doubles the UNet's rows of every step
            "flops_per_image": per_image,
            "sites": self.fam.sites(cfg, 2 * tr["batch"]),
        }

    def free(self) -> None:
        del self.runner
        gc.collect()
        torch.cuda.empty_cache()

    def sample(self) -> List[Dict]:
        done = [r for r in self.results if r["ok"]]
        rng = np.random.default_rng(derive(self.seed, 5))
        k = min(len(done), self.cell.limits["calls"])
        return [done[i] for i in sorted(rng.choice(len(done), k,
                                                   replace=False))]

    def reference_images(self, picked: List[Dict],
                         tf32: bool = False) -> np.ndarray:
        cfg, tr = self.cell.config, self.tr
        stack = self.fam.build_reference(cfg, self.seed, self.dev).eval()
        abar = ref.alpha_bar(cfg, self.dev)
        b, s = tr["batch"], tr["size"] // 8
        d = cfg["unet"]["d_cond"]
        uncond = torch.from_numpy(ref.hash_context([""] * b, d)).to(self.dev)
        out = []
        with lowp.tf32_allowed(tf32):
            for r in picked:
                cond = torch.from_numpy(ref.hash_context([r["prompt"]] * b,
                                                         d)).to(self.dev)
                g = torch.Generator(device=self.dev).manual_seed(r["seed"])
                x = torch.randn((b, s, s, cfg["unet"]["in_channels"]),
                                generator=g, device=self.dev)
                z = ref.sample_dpmpp(stack.unet, x, cond, uncond, tr["scale"],
                                     abar, tr["steps"])
                with torch.no_grad():
                    out.append(stack.ae.decode(z).cpu().numpy())
        del stack
        return np.concatenate(out)

    def check(self, controls: bool = False) -> Dict:
        lim = self.cell.limits
        picked = self.sample()
        failed = sum(1 for r in self.results if not r["ok"])
        errors = [r["out"] for r in self.results if not r["ok"]][:3]
        self.free()
        out = {"attempted": len(self.results), "failed": failed,
               "errors": errors, "checks": []}
        if not picked:
            out["checks"].append({"name": "calls_compared", "value": 0,
                                  "limit": 1, "ok": False})
            return out
        want = self.reference_images(picked)
        gap = image_gap(np.concatenate([r["out"] for r in picked]), want)
        out["checks"] = limit_checks({"image_rel_l2": gap}, lim["compared"])
        if controls:
            out["control"] = {"tf32": {"image_rel_l2": image_gap(
                self.reference_images(picked, tf32=True), want)}}
        return out
