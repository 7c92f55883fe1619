"""Closed-loop callers of the port's ``LdmRunner.txt2img`` on an SDXL
configuration: ``txt2img_closed_loop``'s traffic, window and check, with
the conditioning pair.

- A traced window records the program's spans beside the device trace
  (``bench_gpu.spans.SpanTracer`` in place of the tracer it is handed),
  so that span readers such as ``transformer_ms.gen`` have spans to read.
- The check generates the sampled calls again with the plain float32
  reference (``bench_gpu/reference/sdxl.py``: UNet, DPM-Solver++ with
  guidance over the (context, y) pair, VAE decoder) from the same prompt
  hash, size embeddings and start latents, and compares each image by its
  relative L2 distance.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from bench_gpu.drivers import txt2img_closed_loop
from bench_gpu.reference import lowp
from bench_gpu.reference import sdxl as ref
from bench_gpu.spans import SpanTracer


class Session(txt2img_closed_loop.Session):
    def window(self, seconds: float, tracer=None) -> Dict:
        return super().window(seconds,
                              None if tracer is None else SpanTracer())

    def reference_images(self, picked: List[Dict],
                         tf32: bool = False) -> np.ndarray:
        cfg, tr = self.cell.config, self.tr
        stack = self.fam.build_reference(cfg, self.seed, self.dev).eval()
        abar = ref.alpha_bar(cfg, self.dev)
        b, px = tr["batch"], tr["size"]
        out = []
        with lowp.tf32_allowed(tf32):
            for r in picked:
                cond, uncond = ref.conditioning(cfg, [r["prompt"]] * b, px,
                                                px, self.dev)
                g = torch.Generator(device=self.dev).manual_seed(r["seed"])
                x = torch.randn((b, px // 8, px // 8,
                                 cfg["unet"]["in_channels"]),
                                generator=g, device=self.dev)
                z = ref.sample_dpmpp_pair(stack.unet, x, cond, uncond,
                                          tr["scale"], abar, tr["steps"])
                with torch.no_grad():
                    out.append(stack.ae.decode(z).cpu().numpy())
        del stack
        return np.concatenate(out)
