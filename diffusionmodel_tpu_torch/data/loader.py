"""Host-side batch loader with background prefetch: the port's numpy-only
copy of ``diffusionmodel_tpu/data/loader.py``.

A replacement for torch DataLoader(num_workers=5, pin_memory)
(new_scripy.py:641-655): a thread pool decodes/augments images while the
device trains, and batches are yielded as numpy arrays shaped for gradient
accumulation ([accum, micro_batch, ...]). The tail batch is padded by
wrapping around, and with ``wire_u8`` (default) images and masks travel as
uint8 (``dataset.load_wire``), expanded on the device by
``train.decode_wire``: 16x fewer host-to-device bytes than float32.

With a distributed ``mesh`` every process shuffles with the same seed and
decodes only its contiguous block of the B axis of each [A, B, ...]
batch: the JAX package's ``batch_sharding(mesh, 5, 1)``. With ``spatial``
(the mesh's 'spatial' axis, for a model with the spatial hooks) each
process keeps the H-block of its images and masks as well:
``image_sharding(mesh, 5, batch_axis=1, h_axis=2)``. The processes of one
'spatial' group decode the same images (their H-blocks, or, without
``spatial``, the whole images: replicas), so on a mesh with a 'spatial'
axis the loader draws the horizontal flips itself, in order from its own
seeded generator, where the dataset would draw them in whatever order its
worker threads run.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Sequence

import numpy as np


class BatchLoader:
    def __init__(self, dataset, indices: Sequence[int], batch_size: int,
                 accum_steps: int = 1, shuffle: bool = True, augment: bool = True,
                 seed: int = 0, num_workers: int = 4, prefetch: int = 2,
                 drop_last: bool = False, wire_u8: bool = True, mesh=None,
                 spatial: bool = False):
        self.dataset = dataset
        self.indices = np.asarray(indices)
        self.batch_size = batch_size
        self.accum_steps = accum_steps
        self.shuffle = shuffle
        self.augment = augment
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.drop_last = drop_last
        self._rng = np.random.RandomState(seed)
        # uint8 wire format (image u8, mask class-index u8), expanded
        # on the device by train.decode_wire.
        self.wire_u8 = wire_u8 and hasattr(dataset, "load_wire")
        # this process's rows of B (all of them without a mesh)
        self.rows = slice(0, batch_size)
        # this process's rows of H (all of them unless spatial)
        self.h_rows = slice(None)
        self.flip_prob = 0.0
        if mesh is not None and mesh.distributed:
            from diffusionmodel_tpu_torch.parallel import (
                batch_sharding,
                image_sharding,
            )

            self.rows = batch_sharding(mesh, 2, 1).block(1, batch_size)
            if mesh.shape["spatial"] > 1:
                if spatial:
                    self.h_rows = image_sharding(mesh, 5, 1, 2).block(
                        2, dataset.img_size)
                if augment:
                    self.flip_prob = getattr(dataset, "hflip_prob", 0.0)

    def __len__(self) -> int:
        per_step = self.batch_size * self.accum_steps
        n = len(self.indices)
        return n // per_step if self.drop_last else -(-n // per_step)

    def _epoch_order(self) -> np.ndarray:
        order = self.indices.copy()
        if self.shuffle:
            self._rng.shuffle(order)
        return order

    def _assemble(self, idxs: np.ndarray, flips=None
                  ) -> Dict[str, np.ndarray]:
        per_step = self.batch_size * self.accum_steps
        # pad the tail batch by wrapping (every step has the same shape)
        if len(idxs) < per_step:
            pad = per_step - len(idxs)
            idxs = np.concatenate([idxs, idxs[: pad]]) if len(idxs) >= pad else \
                np.concatenate([idxs, np.resize(idxs, pad)])
        load = (self.dataset.load_wire if self.wire_u8
                else self.dataset.load)
        idxs = idxs.reshape(self.accum_steps, self.batch_size)[:, self.rows]
        b = idxs.shape[1]
        if flips is not None:
            flips = flips.reshape(self.accum_steps,
                                  self.batch_size)[:, self.rows].reshape(-1)
        xs, cs, ms = [], [], []
        for k, i in enumerate(idxs.reshape(-1)):
            x, c, m = load(int(i), augment=self.augment and flips is None)
            if flips is not None and flips[k]:
                x = x[:, ::-1]
                if getattr(self.dataset, "co_flip_mask", False):
                    m = m[:, ::-1]
            xs.append(x[self.h_rows])
            cs.append(c)
            ms.append(m[self.h_rows])
        s = self.dataset.img_size
        x = np.stack(xs).reshape(self.accum_steps, b, xs[0].shape[0], s, -1)
        c = np.asarray(cs, np.int32).reshape(self.accum_steps, b)
        m = np.stack(ms).reshape(self.accum_steps, b, xs[0].shape[0], s)
        return {"x": x, "c": c, "mask": m}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._epoch_order()
        per_step = self.batch_size * self.accum_steps
        n_batches = len(self)
        chunks = [
            order[i * per_step:(i + 1) * per_step] for i in range(n_batches)
        ]
        # the flips the loader draws itself (spatial), per chunk, in order
        flips = [self._rng.rand(per_step) < self.flip_prob
                 if self.flip_prob > 0 else None for _ in chunks]
        if self.num_workers <= 0:
            for ch, fl in zip(chunks, flips):
                yield self._assemble(ch, fl)
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            # Bounded in-flight window (num_workers + prefetch chunks): each
            # chunk is submitted only as an earlier one is handed off, so at
            # most window+prefetch assembled batches exist at once — the
            # epoch's decoded images can never pile up in host RAM.
            window = self.num_workers + self.prefetch
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    from collections import deque

                    futs = deque(pool.submit(self._assemble, ch, fl)
                                 for ch, fl in zip(chunks[:window],
                                                   flips[:window]))
                    next_i = len(futs)
                    while futs:
                        if stop.is_set():
                            for f in futs:
                                f.cancel()
                            return
                        item = futs.popleft().result()
                        if next_i < len(chunks):
                            futs.append(pool.submit(
                                self._assemble, chunks[next_i], flips[next_i]))
                            next_i += 1
                        while not stop.is_set():
                            try:
                                q.put(item, timeout=0.1)
                                break
                            except queue.Full:
                                continue
                q.put(None)
            except BaseException as e:
                # a failed decode (corrupt image, bad XML) must not strand
                # the consumer on q.get() forever — hand it the exception.
                while not stop.is_set():
                    try:
                        q.put(e, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
