"""Optimizer steps of the port's training step, fed as ``trainer.fit`` feeds
it.

Traffic parameters: ``accum_steps`` x ``micro_batch`` images a step, in
the uint8 wire format, from a pool of ``pool_batches`` distinct batches
staged on the host from the seed (``traffic.crack_batches``) and taken in
turn; ``steps_per_epoch`` for the rate schedule; ``trace_seconds``.

Set-up builds one training state and drives it through its first
``checked_steps`` steps with the window's own call and feed, under the
port's float32 settings with cuDNN autotuned (as ``fit`` runs): the first
pays cuDNN's search. It keeps, for the check, each step's loss, the
first gradient as the optimizer took it (Adam's first moment after one
step over 1 - b1) and the parameters after the last, as leaf norms. The
same state then runs the window: steps until ``--seconds`` have passed,
the window closing when the last of them has finished.

Correctness: the plain float32 reference runs the same steps from the same
seeded weights on the same batches and draws (``reference/diffusion.py``);
each step's loss and, by leaf, the first gradient's norm and the
parameters' change are read against it (``compare``). The same steps by
the reference with its products rounded to the configuration's precision
(``limits: baseline``), the first of them, gives the scale of a sound
computation in that precision: each first-step gap is also read over the
baseline's (``*_over_baseline``), which divides out how much a seed's
weights and draws amplify rounding. The limits file names the numbers
compared.
"""

from __future__ import annotations

import gc
from typing import Dict, Optional

import numpy as np
import torch

from bench_gpu import harness, loops, traffic
from bench_gpu.checks import compare, limit_checks, over_baseline
from bench_gpu.reference import diffusion as refdiff
from bench_gpu.reference import lowp
from bench_gpu.reference.context_unet import set_quant
from bench_gpu.weights import derive, initial

B1 = 0.9  # Adam's b1 in the configuration's optimizer


class Session:
    def __init__(self, cell: harness.Cell, seed: int, device):
        from diffusionmodel_tpu_torch.train import (
            create_train_state,
            make_train_step,
        )

        self.cell, self.seed, self.dev = cell, seed, device
        self.tr = tr = cell.traffic
        self.fam = harness.family(cell.config)
        self.pc, model, sched = self.fam.build_program(
            cell.config, seed, device, tr.get("program"))
        self.state, opt = create_train_state(model, self.pc,
                                             tr["steps_per_epoch"])
        self.step = make_train_step(model, sched, self.pc, opt)
        self.pool = traffic.crack_batches(tr, cell.config, seed,
                                          tr["pool_batches"])
        self.gen = torch.Generator(device=device).manual_seed(
            derive(seed, 6))
        self.k = 0
        self.readings: Dict = {}

    def _batch(self, k: int) -> Dict:
        p = k % self.tr["pool_batches"]
        return {n: v[p] for n, v in self.pool.items()}

    def _run(self, k: int) -> torch.Tensor:
        return self.step(self.state, self._batch(k), self.gen)

    def _compute(self):
        from diffusionmodel_tpu_torch.device_check import fp32_compute

        return fp32_compute(self.dev)

    def warm(self) -> None:
        names = [n for n, _ in self.state.model.named_parameters()]
        losses = []
        with self._compute():
            for k in range(self.tr["checked_steps"]):
                losses.append(float(self._run(k)))
                self.k += 1
                if k == 0:
                    mu = self.state.opt_state.mu
                    g1 = torch.stack(torch._foreach_norm(
                        [m.float() for m in mu])) / (1.0 - B1)
                    self.readings["grad"] = dict(zip(names, g1.tolist()))
        change = {}
        for name, p, v in initial(self.state.model, self.seed):
            change[name] = float(torch.linalg.vector_norm(p.detach() - v))
        self.readings["loss"] = losses
        self.readings["change"] = change

    def window(self, seconds: float, tracer=None) -> Dict:
        images = self.tr["accum_steps"] * self.tr["micro_batch"]

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
            "trained_images": len(done) * images,
            "peak_bytes_window": peak,
            "trace": None if tracer is None else tracer.finish(),
            "dtype": cfg["model"]["dtype"],
            "flops_per_image": self.fam.train_flops(cfg, 1),
        }

    def free(self) -> None:
        del self.state, self.step
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, quant: Optional[str] = None,
                  fault: Optional[str] = None,
                  steps: Optional[int] = None) -> Dict:
        """The checked steps (``steps``: the first few of them) by the
        plain float32 reference: losses, the first clipped gradient's leaf
        norms, the parameters' change after the last. ``quant``: the
        rounding of a control or the baseline; ``fault``: ``"half_batch"``
        takes each micro-batch's loss over its first half only."""
        cfg, tr = self.cell.config, self.tr
        dc, tc = cfg["diffusion"], cfg["train"]
        net = self.fam.build_reference(cfg, self.seed, self.dev).train()
        set_quant(net, lowp.QUANTS[quant] if quant else None)
        names = [n for n, _ in net.named_parameters()]
        params = [p for _, p in net.named_parameters()]
        lr = float(np.float32(tc["lr"]))
        opt = refdiff.AdamW(params, lr, tc["weight_decay"], tc["grad_clip"])
        sch = refdiff.schedule(dc["beta1"], dc["beta2"], dc["n_T"], self.dev)
        gen = torch.Generator(device=self.dev).manual_seed(
            derive(self.seed, 6))
        out: Dict = {"loss": []}
        a = tr["accum_steps"]
        with lowp.tf32_allowed(False):
            for k in range(steps or tr["checked_steps"]):
                b = self._batch(k)
                total = 0.0
                for i in range(a):
                    x, mask = refdiff.decode_batch(
                        torch.from_numpy(b["x"][i]).to(self.dev),
                        torch.from_numpy(b["mask"][i]).to(self.dev), dc)
                    c = torch.from_numpy(b["c"][i]).to(self.dev)
                    d = refdiff.draws(gen, x.shape[0], x.shape, dc["n_T"],
                                      dc["drop_prob"], self.dev)
                    if fault == "half_batch":
                        h = x.shape[0] // 2
                        x, mask, c = x[:h], mask[:h], c[:h]
                        d = {n: v[:h] for n, v in d.items()}
                    loss = refdiff.weighted_loss(net, x, c, mask, d,
                                                 sch["abar"], dc)
                    (loss / a).backward()
                    total += float(loss.detach())
                out["loss"].append(total / a)
                grads = [p.grad for p in params]
                took = opt.step(grads)
                if k == 0:
                    out["grad"] = dict(zip(names, torch.stack(
                        torch._foreach_norm(took)).tolist()))
                for p in params:
                    p.grad = None
        out["change"] = {n: float(torch.linalg.vector_norm(p.detach() - v))
                         for n, p, v in initial(net, self.seed)}
        del net, opt
        return out

    def check(self, controls: bool = False) -> Dict:
        lim = self.cell.limits
        self.free()
        want = self.reference()
        # the numbers read over the baseline are the first step's
        base = compare(self.reference(quant=lim["baseline"], steps=1), want,
                       lim["skip_below"])

        def gaps_of(got: Dict) -> Dict:
            gaps = compare(got, want, lim["skip_below"])
            gaps.update(over_baseline(gaps, base))
            return gaps

        gaps = gaps_of(self.readings)
        out = {"attempted": self.window_steps, "failed": self.window_failed,
               "errors": [], "checks": limit_checks(gaps, lim["compared"])}
        out["readings"], out["baseline"] = gaps, base
        if controls:
            out["control"] = {q: gaps_of(self.reference(quant=q))
                              for q in lim["controls"]}
            out["fault"] = {f: gaps_of(self.reference(fault=f))
                            for f in lim["faults"]}
        return out
