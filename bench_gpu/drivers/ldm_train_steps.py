"""Optimizer steps of the port's latent-diffusion train step, fed as
``fit_ldm`` feeds it.

Traffic parameters: ``images`` synthetic images of ``size`` px made from
the seed, each with a prompt drawn from ``prompts``; the frozen VAE's
posterior moments and the prompt-hash contexts computed once in set-up,
in chunks of ``batch`` (as ``fit_ldm`` does); steps of ``batch`` images
taken in a seeded order, each drawing a fresh posterior sample, with
``uncond_prob`` conditioning dropout, Adam at ``lr``, ``remat`` as set;
``checked_steps``; ``trace_seconds``. The runs hold TF32 off
(``device_check.fp32_compute``), as the configuration states.

Set-up builds the runner and the step and drives them through the first
``checked_steps`` steps with the window's own call and feed, keeping the
readings the check compares (``checks.compare``): each step's loss, the
first gradient (Adam's first moment after one step over 1 - b1) and the
parameters' change after the last, as leaf norms. The same objects then
run the window.

Correctness: the plain float32 reference encodes the same images, and
runs the same steps with the same draws from the same seeded weights.
"""

from __future__ import annotations

import gc
from typing import Dict, Optional

import numpy as np
import torch

from bench_gpu import harness, loops
from bench_gpu.checks import compare, limit_checks
from bench_gpu.reference import diffusion as refdiff
from bench_gpu.reference import latent_diffusion as ref
from bench_gpu.reference import lowp
from bench_gpu.weights import derive, initial

B1 = 0.9


def synthetic_images(n: int, size: int, seed: int) -> np.ndarray:
    """[n, size, size, 3] in [-1, 1]: smooth seeded colour fields with a
    dark streak, noise on top."""
    rng = np.random.default_rng(derive(seed, 17))
    low = rng.uniform(-1, 1, (n, 8, 8, 3)).astype(np.float32)
    x = low.repeat(size // 8, 1).repeat(size // 8, 2)
    x += rng.normal(0, 0.05, x.shape).astype(np.float32)
    for i, c in enumerate(rng.integers(size // 8, size - size // 8, n)):
        x[i, :, c:c + size // 64] = -0.9
    return np.clip(x, -1, 1)


class Session:
    def __init__(self, cell: harness.Cell, seed: int, device):
        from diffusionmodel_tpu_torch.models.latent_diffusion.training import (
            adam,
            make_ldm_train_step,
        )

        self.cell, self.seed, self.dev = cell, seed, device
        self.tr = tr = cell.traffic
        self.fam = harness.family(cell.config)
        self.runner = self.fam.build_program(cell.config, seed, device)
        rng = np.random.default_rng(derive(seed, 18))
        self.images = synthetic_images(tr["images"], tr["size"], seed)
        self.prompts = [str(p) for p in rng.choice(tr["prompts"],
                                                   tr["images"])]
        self.order = rng.permutation(tr["images"])
        self.opt = adam(self.runner.unet.parameters(), tr["lr"])
        self.step = make_ldm_train_step(self.runner.unet, self.opt,
                                        uncond_prob=tr["uncond_prob"],
                                        remat=tr["remat"])
        self.gen = torch.Generator(device=device).manual_seed(
            derive(seed, 19))
        self.k = 0
        self.readings: Dict = {}

    def _compute(self):
        from diffusionmodel_tpu_torch.device_check import fp32_compute

        return fp32_compute(self.dev, autotune=False)

    def _idx(self, k: int) -> np.ndarray:
        b, n = self.tr["batch"], self.tr["images"]
        per = n // b
        return self.order[(k % per) * b:(k % per) * b + b]

    def _run(self, k: int) -> torch.Tensor:
        idx = torch.as_tensor(self._idx(k), device=self.dev)
        return self.step((self.mean[idx], self.std[idx]), self.cond[idx],
                         uncond_cond=self.uncond, generator=self.gen)

    def warm(self) -> None:
        """Moments and contexts once (``fit_ldm``'s set-up), then the
        checked steps."""
        b = self.tr["batch"]
        with self._compute():
            self.cond = self.runner.cond(self.prompts)
            self.uncond = self.runner.cond([""])[0]
            means, stds = [], []
            with torch.no_grad():
                for i in range(0, len(self.images), b):
                    d = self.runner.ae.encode(torch.as_tensor(
                        self.images[i:i + b], device=self.dev))
                    means.append(d.mean)
                    stds.append(d.std)
            self.mean, self.std = torch.cat(means), torch.cat(stds)
            names = [n for n, _ in self.runner.unet.named_parameters()]
            losses = []
            for k in range(self.tr["checked_steps"]):
                losses.append(float(self._run(k)))
                self.k += 1
                if k == 0:
                    # no moment: the optimizer took no step
                    mu = [self.opt.state[p].get("exp_avg",
                                                torch.zeros_like(p))
                          for p in self.runner.unet.parameters()]
                    g1 = torch.stack(torch._foreach_norm(mu)) / (1.0 - B1)
                    self.readings["grad"] = dict(zip(names, g1.tolist()))
        self.readings["loss"] = losses
        self.readings["change"] = {
            n: float(torch.linalg.vector_norm(p.detach() - v))
            for n, p, v in initial(self.runner.unet, derive(self.seed, 11))}

    def window(self, seconds: float, tracer=None) -> Dict:
        def step():
            self.k += 1
            return self._run(self.k - 1)

        with self._compute():
            done, window_s, peak = loops.step_loop(
                step, seconds, self.dev, tracer, self.tr["trace_seconds"])
        self.window_failed = int((~np.isfinite(done)).sum())
        self.window_steps = len(done)
        cfg = self.cell.config
        return {
            "window_s": window_s,
            "trained_images": len(done) * self.tr["batch"],
            "peak_bytes_window": peak,
            "trace": None if tracer is None else tracer.finish(),
            "dtype": cfg["dtype"],
            "flops_per_image": self.fam.unet_train_flops(cfg, 1),
            "sites": self.fam.sites(cfg, self.tr["batch"]),
        }

    def free(self) -> None:
        del self.runner, self.opt, self.step
        self.mean = self.std = self.cond = self.uncond = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, tf32: bool = False,
                  fault: Optional[str] = None) -> Dict:
        """The checked steps by the plain float32 reference; ``tf32``: the
        control; ``fault="half_batch"``: each step's loss over the first
        half of its batch only."""
        cfg, tr = self.cell.config, self.tr
        stack = self.fam.build_reference(cfg, self.seed, self.dev)
        unet = stack.unet.train()
        names = [n for n, _ in unet.named_parameters()]
        params = [p for _, p in unet.named_parameters()]
        opt = refdiff.AdamW(params, float(np.float32(tr["lr"])), 0.0, 0.0)
        abar = ref.alpha_bar(cfg, self.dev)
        d = cfg["unet"]["d_cond"]
        gen = torch.Generator(device=self.dev).manual_seed(derive(self.seed,
                                                                  19))
        out: Dict = {"loss": []}
        with lowp.tf32_allowed(tf32):
            with torch.no_grad():
                moments = [stack.ae.moments(torch.as_tensor(
                    self.images[i:i + tr["batch"]], device=self.dev))
                    for i in range(0, len(self.images), tr["batch"])]
            mean = torch.cat([m for m, _ in moments])
            std = torch.cat([s for _, s in moments])
            cond_all = torch.from_numpy(ref.hash_context(self.prompts, d)
                                        ).to(self.dev)
            uncond = torch.from_numpy(ref.hash_context([""], d)[0]
                                      ).to(self.dev)
            for k in range(tr["checked_steps"]):
                idx = torch.as_tensor(self._idx(k), device=self.dev)
                b = len(idx)
                zn = torch.randn(mean[idx].shape, generator=gen,
                                 device=self.dev)
                t = torch.randint(0, abar.shape[0], (b,), generator=gen,
                                  device=self.dev)
                eps = torch.randn(mean[idx].shape, generator=gen,
                                  device=self.dev)
                drop = torch.rand(b, generator=gen, device=self.dev) \
                    < tr["uncond_prob"]
                z0 = ref.SCALE * (mean[idx] + std[idx] * zn)
                cond = cond_all[idx]
                if fault == "half_batch":
                    h = b // 2
                    z0, cond, t, eps, drop = (v[:h] for v in
                                              (z0, cond, t, eps, drop))
                loss = ref.eps_loss(unet, z0, cond, uncond, abar, t, eps,
                                    drop)
                loss.backward()
                out["loss"].append(float(loss.detach()))
                took = opt.step([p.grad for p in params])
                if k == 0:
                    out["grad"] = dict(zip(names, torch.stack(
                        torch._foreach_norm(took)).tolist()))
                for p in params:
                    p.grad = None
        out["change"] = {n: float(torch.linalg.vector_norm(p.detach() - v))
                         for n, p, v in initial(unet, derive(self.seed, 11))}
        del stack, opt
        return out

    def check(self, controls: bool = False) -> Dict:
        lim = self.cell.limits
        self.free()
        want = self.reference()
        gaps = compare(self.readings, want, lim["skip_below"])
        out = {"attempted": self.window_steps, "failed": self.window_failed,
               "errors": [], "checks": limit_checks(gaps, lim["compared"])}
        out["readings"] = gaps
        if controls:
            out["control"] = {"tf32": compare(self.reference(tf32=True),
                                              want, lim["skip_below"])}
            out["fault"] = {f: compare(self.reference(fault=f), want,
                                       lim["skip_below"])
                            for f in lim["faults"]}
        return out
