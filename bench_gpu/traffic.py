"""The general generators that read a traffic file's parameters. The same
seed gives the same requests and the same batches.

- ``serve_requests``: one client's endless stream of generation requests:
  images per request, classes, guidance scale, and a pinned seed on a
  share of them.
- ``prompt_calls``: one text-to-image caller's stream of prompts and
  start-latent seeds.
- ``crack_batches``: synthetic crack images in the uint8 wire format with
  their class labels and loss-mask class indices (0 low, 1 mid, 2 high
  weight), as the crack data set yields them: a smooth random field with
  a dark streak, the lower half at mid weight, the damage box at high.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from bench_gpu.weights import derive


def serve_requests(tr: Dict, seed: int, client: int) -> Iterator[Dict]:
    rng = np.random.default_rng(derive(seed, 3, client))
    k = 0
    while True:
        n = int(rng.choice(tr["images_per_request"]))
        classes = [int(c) for c in rng.integers(0, tr["classes"], n)]
        guide = float(rng.choice(tr["guide_w"]))
        pinned = bool(rng.random() < tr["pinned_share"])
        yield {"classes": classes, "guide_w": guide,
               "seed": derive(seed, 4, client, k) if pinned else None}
        k += 1


def prompt_calls(tr: Dict, seed: int, caller: int) -> Iterator[Dict]:
    """One text-to-image caller's endless stream: a prompt drawn from
    ``prompts`` and the seed of the call's start-latent generator."""
    rng = np.random.default_rng(derive(seed, 14, caller))
    k = 0
    while True:
        yield {"prompt": str(rng.choice(tr["prompts"])),
               "seed": derive(seed, 15, caller, k)}
        k += 1


def crack_batches(tr: Dict, cfg: Dict, seed: int, count: int) -> Dict:
    """``count`` distinct batches of [accum, micro] images: x [P,A,B,S,S,C]
    uint8, c [P,A,B] int64, mask [P,A,B,S,S] uint8."""
    m = cfg["model"]
    s, ch = m["img_size"], m["in_ch"]
    a, b = tr["accum_steps"], tr["micro_batch"]
    n = count * a * b
    rng = np.random.default_rng(derive(seed, 7))
    low = rng.uniform(0, 255, (n, 8, 8, ch)).astype(np.float32)
    x = low.repeat(s // 8, 1).repeat(s // 8, 2)
    x += rng.normal(0, 12, (n, s, s, ch)).astype(np.float32)
    mask = np.zeros((n, s, s), np.uint8)
    mask[:, s // 2:, :] = 1
    y0 = rng.integers(0, s // 2, n)
    x0 = rng.integers(0, s // 2, n)
    hh = rng.integers(s // 8, s // 2, n)
    ww = rng.integers(s // 8, s // 2, n)
    for i in range(n):
        mask[i, y0[i]:y0[i] + hh[i], x0[i]:x0[i] + ww[i]] = 2
        col = x0[i] + ww[i] // 2
        x[i, y0[i]:y0[i] + hh[i], col:col + max(2, s // 64)] = 20.0
    c = rng.integers(0, m["n_classes"], n)
    return {"x": np.clip(x, 0, 255).astype(np.uint8).reshape(
                count, a, b, s, s, ch),
            "c": c.astype(np.int64).reshape(count, a, b),
            "mask": mask.reshape(count, a, b, s, s)}
