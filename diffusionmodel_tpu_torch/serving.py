"""Generation serving: request batching over one warm model (counterpart of
``diffusionmodel_tpu/serving.py``).

- **Fixed slots.** Requests are packed into a fixed ``max_batch`` slot
  layout; padding slots carry noise of their own. Classes and guidance
  scales are per slot, so requests with different scales share a batch.
- **A single owner thread drives the device.** Callers enqueue requests and
  block on futures; the worker drains the queue, packs requests into the
  slot layout, runs the sampler, and slices the results back out. A request
  that does not fit the current batch is held as the HEAD of the next one
  (strict FIFO).

Determinism: each request's start noise comes from its own seed on the
host (``np.random.default_rng(seed)``, the same draw as the JAX package,
so a pinned request starts from the same x_T in both). Under the
deterministic samplers ("dpmpp", and "ddim" with eta=0) that is the only
randomness; under the stochastic ones ("ancestral", "ddim" with eta>0)
the per-step noise rides per-slot generators seeded from the request seed
(``diffusion._slot_normal``). So a request's images depend only on its
seed, classes and scale, never on what shares its batch: the kernels sum
in a fixed order and use no atomics, which keeps that true on the GPU.
Seeds are validated and normalised to [0, 2**63) at ``submit`` time.
Unpinned requests draw seeds from the service RNG (OS entropy unless
``service_seed`` is given).

A "textbook" schedule family checkpoint (the ``labml`` preset's
``ddpm_unet``) is served by the textbook ancestral sampler (t = n_T-1..0,
per-slot noise streams): classes set the slot count only and the guidance
scale is ignored, as in ``trainer.make_sampler``. Its worker holds cuDNN
to deterministic algorithms (``fp32_compute(deterministic=True)``): under
cuDNN's default choice the labml net's eval output did not repeat bit for
bit on the card. Mesh fan-out is not ported yet (ROADMAP A12).
"""

from __future__ import annotations

import operator
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from diffusionmodel_tpu_torch.config import Config
from diffusionmodel_tpu_torch.device_check import fp32_compute
from diffusionmodel_tpu_torch.diffusion import (
    Schedule,
    sample_cfg,
    sample_cfg_ddim,
    sample_cfg_dpmpp,
)
from diffusionmodel_tpu_torch.models.annotated_ddpm.diffusion import (
    make_textbook_chunk_fn,
    textbook_chunk_steps,
)
from diffusionmodel_tpu_torch.utils.grid import png_bytes


@dataclass
class _Request:
    classes: np.ndarray
    guide_w: float
    seed: Optional[int]
    future: Future = field(default_factory=Future)


class SamplerService:
    """Batched generation service over a denoiser (an ``nn.Module`` on the
    schedule's device, put in eval mode here).

    ``sampler``: "ddim" (default of the serve CLI), "dpmpp", or
    "ancestral" (the reference's full-T loop); a textbook-family config
    takes the textbook sampler whatever ``sampler`` says."""

    def __init__(self, model, cfg: Config, sched: Schedule,
                 max_batch: int = 8, sampler: Optional[str] = None,
                 max_wait_ms: float = 20.0,
                 service_seed: Optional[int] = None):
        mc, dc, sc = cfg.model, cfg.diffusion, cfg.sample
        kind = ("textbook" if dc.schedule_family == "textbook"
                else sampler or sc.sampler)
        if kind not in ("ddim", "dpmpp", "ancestral", "textbook"):
            raise ValueError(f"unknown sampler kind: {kind}")
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.n_classes = mc.n_classes
        self.schedule_family = dc.schedule_family
        self.device = sched.device
        self._np_rng = np.random.default_rng(service_seed)
        self._gen = torch.Generator(device=self.device).manual_seed(
            int(self._np_rng.integers(2 ** 63)))
        shape = (mc.img_size, mc.img_size, mc.in_ch)
        self._shape = shape
        model.eval()
        if kind == "textbook":
            chunk = make_textbook_chunk_fn(model, dc, max_batch, shape)
            steps = textbook_chunk_steps(dc.n_T)

        def run(classes, guide_w, x_init=None, slot_seeds=None):
            if kind == "textbook":
                x = torch.as_tensor(x_init, dtype=torch.float32).to(
                    self.device)
                return chunk(x, self._gen, steps, slot_seeds=slot_seeds)
            common = dict(classes=classes, x_init=x_init)
            if kind == "dpmpp":
                return sample_cfg_dpmpp(
                    model, self._gen, max_batch, shape, mc.n_classes, sched,
                    dc, guide_w=guide_w, n_steps=sc.dpm_steps,
                    discretize=sc.ddim_discretize, **common)
            if kind == "ddim":
                return sample_cfg_ddim(
                    model, self._gen, max_batch, shape, mc.n_classes, sched,
                    dc, guide_w=guide_w, n_steps=sc.ddim_steps,
                    eta=sc.ddim_eta, discretize=sc.ddim_discretize,
                    slot_seeds=slot_seeds, **common)
            return sample_cfg(model, self._gen, max_batch, shape,
                              mc.n_classes, sched, dc, guide_w=guide_w,
                              slot_seeds=slot_seeds, **common)

        self._run = run
        self._textbook = kind == "textbook"
        self._deterministic = (kind == "dpmpp"
                               or (kind == "ddim" and sc.ddim_eta == 0.0))
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._closed = False
        # observability: written by the worker thread only; read from
        # /healthz and tests. slot_occupancy = slots used / dispatched.
        self.stats = {
            "requests": 0, "batches": 0,
            "slots_used": 0, "slots_dispatched": 0,
            "pinned_batches": 0, "busy_seconds": 0.0,
        }
        self._worker = threading.Thread(target=self._serve, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------- public
    def submit(self, classes: Sequence[int], guide_w: float = 4.0,
               seed: Optional[int] = None) -> Future:
        """Request len(classes) images (one per class label). Returns a
        Future resolving to [len(classes), H, W, C] float32 images."""
        classes = np.asarray(classes, np.int32)
        if classes.ndim != 1 or not 0 < len(classes) <= self.max_batch:
            raise ValueError(
                f"classes must be 1D with 1..{self.max_batch} entries")
        if (classes < 0).any() or (classes >= self.n_classes).any():
            raise ValueError(
                f"class ids must be in [0, {self.n_classes}), got "
                f"{sorted(set(int(c) for c in classes))}")
        if seed is not None:
            # a bad seed fails its own request here, never batch
            # neighbours inside the worker; integral floats (JSON clients)
            # are accepted, negatives map into [0, 2**63).
            if isinstance(seed, float) and seed.is_integer():
                seed = int(seed)
            try:
                seed = operator.index(seed) % (2 ** 63)
            except TypeError:
                raise ValueError(
                    f"seed must be an integer, got {type(seed).__name__}")
        if self._closed:
            raise RuntimeError("service is closed")
        req = _Request(classes, float(guide_w), seed)
        self._q.put(req)
        return req.future

    def generate(self, classes: Sequence[int], guide_w: float = 4.0,
                 seed: Optional[int] = None) -> np.ndarray:
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(classes, guide_w, seed).result()

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._q.put(None)
            self._worker.join()
            # fail any request that raced past the _closed check in
            # submit() and landed behind the shutdown sentinel.
            while True:
                try:
                    req = self._q.get_nowait()
                except queue.Empty:
                    break
                if req is not None and not req.future.done():
                    req.future.set_exception(RuntimeError("service closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ------------------------------------------------------------- worker
    def _collect(self, req: _Request):
        """The batch headed by ``req``, and the request held for the next."""
        batch, slots, pending = [req], len(req.classes), None
        deadline = time.monotonic() + self.max_wait_s
        while slots < self.max_batch:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                nxt = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if nxt is None:
                self._q.put(None)  # re-post the shutdown signal
                break
            if slots + len(nxt.classes) <= self.max_batch:
                batch.append(nxt)
                slots += len(nxt.classes)
            else:
                pending = nxt
                break
        return batch, slots, pending

    def _pack(self, batch):
        """Host-side slot layout: classes, per-slot guidance, start noise
        from each request's own seed, per-slot seeds for the stochastic
        samplers."""
        h, w, ch = self._shape
        flat = np.zeros(self.max_batch, np.int64)
        gw = np.full(self.max_batch, batch[0].guide_w, np.float32)
        x_init = np.empty((self.max_batch, h, w, ch), np.float32)
        slot_seeds = (None if self._deterministic
                      else np.zeros(self.max_batch, np.uint32))
        off = 0
        for r in batch:
            k = len(r.classes)
            flat[off:off + k] = r.classes
            gw[off:off + k] = r.guide_w
            sd = (r.seed if r.seed is not None
                  else int(self._np_rng.integers(2 ** 63)))
            x_init[off:off + k] = np.random.default_rng(sd).standard_normal(
                (k, h, w, ch), np.float32)
            if slot_seeds is not None:
                slot_seeds[off:off + k] = (
                    np.random.SeedSequence(sd).generate_state(k))
            off += k
        if off < self.max_batch:  # padding slots
            pad_sd = int(self._np_rng.integers(2 ** 63))
            x_init[off:] = np.random.default_rng(pad_sd).standard_normal(
                (self.max_batch - off, h, w, ch), np.float32)
            if slot_seeds is not None:
                slot_seeds[off:] = np.random.SeedSequence(
                    pad_sd).generate_state(self.max_batch - off)
        return flat, gw, x_init, slot_seeds

    def _serve(self) -> None:
        # fp32 with TF32 off for the service's lifetime, set by this thread
        # alone (the flags are process settings). cuDNN autotuned: the slot
        # batch has one shape, so one algorithm serves every request. cuDNN
        # keeps its choices per thread, so each service searches once, in
        # its first batch (~50 s), and saves 12.7% of every batch after it
        # (DDIM-50 at max_batch 8: 34.7 -> 30.3 s; NVIDIA H100,
        # tools/fp32_autotune_probe.py). The textbook kind also holds cuDNN
        # to its deterministic algorithms (module docstring).
        with fp32_compute(self.device, deterministic=self._textbook):
            self._serve_loop()

    def _serve_loop(self) -> None:
        pending: Optional[_Request] = None  # held batch head (FIFO)
        while True:
            req, pending = (pending, None) if pending is not None \
                else (self._q.get(), None)
            if req is None:
                break
            batch, slots, pending = self._collect(req)
            try:
                flat, gw, x_init, slot_seeds = self._pack(batch)
                t_run = time.monotonic()
                imgs = self._run(
                    torch.from_numpy(flat).to(self.device),
                    torch.from_numpy(gw).to(self.device), x_init,
                    None if slot_seeds is None else slot_seeds.tolist(),
                ).cpu().numpy()
                st = self.stats
                st["busy_seconds"] += time.monotonic() - t_run
                st["batches"] += 1
                st["requests"] += len(batch)
                st["slots_used"] += slots  # == images generated
                st["slots_dispatched"] += self.max_batch
                if any(r.seed is not None for r in batch):
                    st["pinned_batches"] += 1
                off = 0
                for r in batch:
                    r.future.set_result(imgs[off:off + len(r.classes)])
                    off += len(r.classes)
            except Exception as e:  # the worker outlives a failed batch
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)


# ---------------------------------------------------------------- HTTP API
def make_http_server(service: SamplerService, host: str = "0.0.0.0",
                     port: int = 8000, class_names: Optional[list] = None,
                     denorm: bool = True):
    """Minimal stdlib HTTP front-end over a :class:`SamplerService`.

    - ``GET /healthz`` -> {"status": "ok", "classes": [...], "stats": ...}
    - ``POST /generate`` with JSON {"classes": [ids or names],
      "guide_w": 4.0, "seed": null} -> {"images": [<base64 PNG>, ...]}

    Returns an ``http.server.ThreadingHTTPServer`` (the caller drives
    ``serve_forever``; handler threads block on service futures while the
    single service worker owns the device)."""
    import base64
    import json
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    names = class_names or []
    name_to_id = {n: i for i, n in enumerate(names)}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                st = dict(service.stats)
                st["images"] = st["slots_used"]
                occ = (st["slots_used"] / st["slots_dispatched"]
                       if st["slots_dispatched"] else None)
                self._send(200, {"status": "ok", "classes": names,
                                 "max_batch": service.max_batch,
                                 "stats": st, "slot_occupancy": occ})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/generate":
                self._send(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                classes = [name_to_id.get(c, c) if isinstance(c, str) else c
                           for c in req.get("classes", [0])]
                imgs = service.generate(
                    [int(c) for c in classes],
                    guide_w=float(req.get("guide_w", 4.0)),
                    seed=req.get("seed"))
                out = []
                for im in imgs:
                    arr = im * 0.5 + 0.5 if denorm else im
                    arr = np.clip(arr * 255.0, 0, 255).astype(np.uint8)
                    out.append(base64.b64encode(png_bytes(arr)).decode())
                self._send(200, {"images": out})
            except (ValueError, KeyError, TypeError) as e:
                self._send(400, {"error": str(e)})
            except Exception as e:  # the server outlives a failed request
                self._send(500, {"error": str(e)})

    return ThreadingHTTPServer((host, port), Handler)
