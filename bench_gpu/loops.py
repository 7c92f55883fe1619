"""The two shapes of measured window the drivers share.

- ``closed_loop``: client threads, each calling again as soon as its last
  call returned, until ``seconds`` have passed; the window closes when the
  last call sent inside it returns.
- ``step_loop``: one host thread issuing steps until ``seconds`` have
  passed; the window closes when the last step started inside it has
  finished on the device.

Both start the tracer (if any) at the window's opening and stop it after
``trace_seconds``; its events are reduced once the window has closed.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Iterator, List

import torch


def closed_loop(streams: List[Iterator[Dict]], call: Callable[[Dict], object],
                seconds: float, tracer=None, trace_seconds: float = 0.0
                ) -> tuple:
    """Runs ``call(request)`` for each client's stream of requests. Returns
    (every call's record: the request, ``t0`` / ``t1``, ``ok`` and
    ``out`` (the result, or the exception's repr), the window's seconds)."""
    per: List[List[Dict]] = [[] for _ in streams]
    deadline = [0.0]

    def client(i: int) -> None:
        while time.perf_counter() < deadline[0]:
            req = next(streams[i])
            t0 = time.perf_counter()
            try:
                out, ok = call(req), True
            except Exception as e:  # a failed call is counted, not raised
                out, ok = repr(e), False
            per[i].append({**req, "t0": t0, "t1": time.perf_counter(),
                           "ok": ok, "out": out})

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(streams))]
    if tracer is not None:
        tracer.start()
    t_start = time.perf_counter()
    deadline[0] = t_start + seconds
    for t in threads:
        t.start()
    if tracer is not None:
        time.sleep(min(trace_seconds, seconds))
        tracer.stop()
    for t in threads:
        t.join()
    return [r for rs in per for r in rs], time.perf_counter() - t_start


def step_loop(step: Callable[[], torch.Tensor], seconds: float, device,
              tracer=None, trace_seconds: float = 0.0) -> tuple:
    """Runs ``step()`` until ``seconds`` have passed. Returns (the steps'
    losses on the host, the window's seconds, the device's memory peak
    over the window or None off the card)."""
    cuda = device.type == "cuda"
    losses = []
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    traced = tracer is not None
    if traced:
        tracer.start()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        losses.append(step())
        if traced and time.perf_counter() - t0 >= trace_seconds:
            tracer.stop()
            traced = False
    if traced:
        tracer.stop()
    if cuda:
        torch.cuda.synchronize(device)
    window = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    return torch.stack(losses).float().cpu().numpy(), window, peak
