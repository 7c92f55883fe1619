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
bit on the card.

**Mesh fan-out** (``mesh=``, a distributed ``parallel.make_mesh``): every
process of the group builds the service on the same weights; rank 0
owns the queue, ``submit`` and the HTTP front end. For each packed batch
rank 0 broadcasts the classes, the guidance vector, the start noise and
the slot seeds; each process denoises its contiguous block of the
``max_batch`` slots over 'data' (the JAX package's ``batch_sharding``
when the data size divides ``max_batch``), and the blocks return to rank
0 by an ``all_reduce`` of zero-padded buffers. When the data size does not
divide ``max_batch`` every process runs the whole batch, as the JAX
package replicates. Processes along 'spatial' run their data block
alike; on a 'model' axis the service cuts the model to this process's
blocks (``parallel.tensor.attach_model_axis``) and the processes along
'model' run their data block together, each layer's output channels
split between them. On the other ranks the worker thread is the follower loop, which
ends when rank 0's ``close()`` broadcasts the stop; their ``close()``
waits for it. A pinned request's images still depend only on its seed,
classes and scale: under a mesh every worker keeps cuDNN on its
heuristics, so a shape takes the same algorithm in every process,
whichever rank's block the request's slots fall in (an autotuned
search is per process and may pick another).
"""

from __future__ import annotations

import itertools
import operator
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from diffusionmodel_tpu_torch import tracing
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
    queued: Optional[object] = None  # its open ``serve.queue`` span
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
                 service_seed: Optional[int] = None, mesh=None):
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
        self.mesh = mesh if mesh is not None and mesh.distributed else None
        # this process's slots of the batch: a block over 'data' when the
        # data size divides max_batch, else all of them
        self._block = slice(0, max_batch)
        if self.mesh is not None:
            from diffusionmodel_tpu_torch.parallel import batch_sharding
            from diffusionmodel_tpu_torch.parallel.tensor import (
                attach_model_axis,
            )

            attach_model_axis(model, self.mesh)
            if max_batch % self.mesh.shape["data"] == 0:
                self._block = batch_sharding(self.mesh, 1).block(0, max_batch)
        if kind == "textbook":
            chunk = make_textbook_chunk_fn(
                model, dc, self._block.stop - self._block.start, shape)
            steps = textbook_chunk_steps(dc.n_T)

        def run(classes, guide_w, x_init=None, slot_seeds=None):
            n = x_init.shape[0]
            if kind == "textbook":
                x = torch.as_tensor(x_init, dtype=torch.float32).to(
                    self.device)
                return chunk(x, self._gen, steps, slot_seeds=slot_seeds)
            common = dict(classes=classes, x_init=x_init)
            if kind == "dpmpp":
                return sample_cfg_dpmpp(
                    model, self._gen, n, shape, mc.n_classes, sched,
                    dc, guide_w=guide_w, n_steps=sc.dpm_steps,
                    discretize=sc.ddim_discretize, **common)
            if kind == "ddim":
                return sample_cfg_ddim(
                    model, self._gen, n, shape, mc.n_classes, sched,
                    dc, guide_w=guide_w, n_steps=sc.ddim_steps,
                    eta=sc.ddim_eta, discretize=sc.ddim_discretize,
                    slot_seeds=slot_seeds, **common)
            return sample_cfg(model, self._gen, n, shape,
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
        # With ``tracing`` on, each request's ``serve.queue`` span runs
        # from submit to the start of its batch's run, and each batch
        # records ``serve.idle`` (the wait for its head), ``serve.collect``,
        # ``serve.pack``, ``serve.run`` and ``serve.unpack``, all with the
        # batch's id.
        self._request_ids = itertools.count()
        self._batch_ids = itertools.count()
        self.stats = {
            "requests": 0, "batches": 0,
            "slots_used": 0, "slots_dispatched": 0,
            "pinned_batches": 0, "busy_seconds": 0.0,
        }
        # cuDNN searches its algorithms per thread, so the processes of a
        # mesh could each pick another one for a shape and sum a request's
        # convolutions in other orders, by which rank's block its slots
        # fall in: under a mesh every worker takes cuDNN's heuristics,
        # which pick the same algorithm for a shape in every process
        self._autotune = self.mesh is None
        self._main = self.mesh is None or self.mesh.is_main
        self._worker = threading.Thread(
            target=self._serve if self._main else self._follow, daemon=True)
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
        if not self._main:
            raise RuntimeError("submit goes to rank 0 of the service's "
                               "group; this process follows it")
        req = _Request(classes, float(guide_w), seed, tracing.begin(
            "serve.queue", request=next(self._request_ids)))
        self._q.put(req)
        return req.future

    def generate(self, classes: Sequence[int], guide_w: float = 4.0,
                 seed: Optional[int] = None) -> np.ndarray:
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(classes, guide_w, seed).result()

    def close(self) -> None:
        """Stop the worker. On rank 0 of a mesh this broadcasts the stop to
        the followers; on a follower it waits for that stop."""
        if not self._closed:
            self._closed = True
            if self._main:
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

    # --------------------------------------------------------- fan-out
    def _exchange(self, batch=None):
        """Rank 0 broadcasts its packed batch (``None``: the stop) and
        every process gets (classes, guidance, start noise, slot seeds),
        or None for the stop. A command word, then the int64 classes and
        slot seeds, then the float32 guidance and start noise."""
        h, w, ch = self._shape
        m = self.max_batch
        ints = torch.zeros(1 + 2 * m, dtype=torch.int64, device=self.device)
        floats = torch.zeros(m * (1 + h * w * ch), dtype=torch.float32,
                             device=self.device)
        if batch is not None:
            flat, gw, x_init, slot_seeds = batch
            ints[0] = 1
            ints[1:1 + m] = torch.from_numpy(flat)
            if slot_seeds is not None:
                ints[1 + m:] = torch.from_numpy(
                    np.asarray(slot_seeds, np.int64))
            floats[:m] = torch.from_numpy(gw)
            floats[m:] = torch.from_numpy(x_init).reshape(-1)
        dist.broadcast(ints, src=0)
        if int(ints[0]) == 0:
            return None
        dist.broadcast(floats, src=0)
        seeds = (None if self._deterministic
                 else ints[1 + m:].cpu().numpy().astype(np.uint32))
        return (ints[1:1 + m], floats[:m],
                floats[m:].reshape(m, h, w, ch), seeds)

    def _run_block(self, classes, gw, x_init, slot_seeds) -> torch.Tensor:
        """This process's block of the batch, denoised; under a mesh with
        a block over 'data', the whole batch on rank 0 (the blocks summed
        into zeros by an all_reduce over 'data')."""
        b = self._block
        seeds = None if slot_seeds is None else list(slot_seeds[b])
        mine = self._run(classes[b], gw[b], x_init[b], seeds)
        if self.mesh is None or b.stop - b.start == self.max_batch:
            return mine
        full = torch.zeros((self.max_batch, *mine.shape[1:]),
                           dtype=mine.dtype, device=mine.device)
        full[b] = mine
        dist.all_reduce(full, group=self.mesh.group("data"))
        return full

    def _follow(self) -> None:
        """A follower's worker: denoise its block of each batch rank 0
        broadcasts, until the stop."""
        with fp32_compute(self.device, self._autotune,
                          deterministic=self._textbook):
            while True:
                got = self._exchange()
                if got is None:
                    return
                self._run_block(*got)

    def _serve(self) -> None:
        # fp32 with TF32 off for the service's lifetime, set by this thread
        # alone (the flags are process settings). cuDNN autotuned without a
        # mesh: the slot batch has one shape, so one algorithm serves every
        # request. cuDNN keeps its choices per thread, so each service
        # searches once, in its first batch (~50 s), and saves 12.7% of
        # every batch after it (DDIM-50 at max_batch 8: 34.7 -> 30.3 s;
        # NVIDIA H100, tools/fp32_autotune_probe.py). The textbook kind
        # also holds cuDNN to its deterministic algorithms (module
        # docstring).
        with fp32_compute(self.device, self._autotune,
                          deterministic=self._textbook):
            self._serve_loop()

    def _serve_loop(self) -> None:
        pending: Optional[_Request] = None  # held batch head (FIFO)
        while True:
            bid = next(self._batch_ids)
            if pending is not None:
                req, pending = pending, None
            else:
                with tracing.span("serve.idle", batch=bid):
                    req = self._q.get()
            if req is None:
                if self.mesh is not None:
                    self._exchange(None)  # the followers stop
                break
            with tracing.span("serve.collect", batch=bid):
                batch, slots, pending = self._collect(req)
            try:
                with tracing.span("serve.pack", batch=bid):
                    packed = self._pack(batch)
                # one pair of clock reads times the run for the stats and
                # for its span
                t_run = tracing.now()
                for r in batch:
                    tracing.end(r.queued, t_run, batch=bid)
                with tracing.span_from(t_run, "serve.run", batch=bid) as run:
                    if self.mesh is not None:
                        imgs = self._run_block(*self._exchange(packed))
                    else:
                        flat, gw, x_init, slot_seeds = packed
                        imgs = self._run_block(
                            torch.from_numpy(flat).to(self.device),
                            torch.from_numpy(gw).to(self.device),
                            torch.from_numpy(x_init).to(self.device),
                            slot_seeds)
                    imgs = imgs.cpu().numpy()
                    t_end = tracing.now()
                    run.close(t_end)
                st = self.stats
                st["busy_seconds"] += (t_end - t_run) / 1e9
                st["batches"] += 1
                st["requests"] += len(batch)
                st["slots_used"] += slots  # == images generated
                st["slots_dispatched"] += self.max_batch
                if any(r.seed is not None for r in batch):
                    st["pinned_batches"] += 1
                with tracing.span("serve.unpack", batch=bid):
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
