"""The traced sub-window: ``torch.profiler`` (CUPTI) over a few seconds of
steady load, reduced to what the per-layer readers take.

The profiler is started in a fresh process right after warm-up: on the
card it drops device events once a process has kept the card busy for
some tens of seconds, so a long-lived process traces short.

The sub-window's edges are read from the trace's own clock, never from
the host's: it opens with the first CUDA runtime call that the trace
holds (the first the host issued after ``start()``) and closes at the
end of the last ``cudaDeviceSynchronize`` (the one ``stop()`` issues,
which returns once the device has finished what was queued).

A reduction holds:

- ``window_s``: the sub-window's length;
- ``busy_s``: the union of the device's operation intervals inside it
  (kernels, copies, sets), each cut to the sub-window (a kernel queued
  before the profiler started can run past its opening): the seconds in
  which something ran;
- ``kernel_s`` / ``launches``: device seconds and launches per name;
- ``device_ops``: the ten names that took most device time;
- ``idle_gaps``: the ten longest gaps between device operations (and
  between the sub-window's edges and the first and last of them), each
  named by the innermost host event that spans its middle (what the host
  was doing while the device waited: with device activity alone traced,
  the CUDA runtime call, such as a launch or a synchronisation).

Only device activity is traced (the host's operator events would slow
the host several times over and read as device idle time), and the
events are reduced after the window has closed (``finish``), so that the
reduction takes no time from the measured load.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple


class Tracer:
    """``start()`` / ``stop()`` around the sub-window; ``finish()`` once
    the window has closed gives the reduction."""

    def __init__(self):
        self.result: Optional[Dict] = None
        self._prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()

    def stop(self) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()

    def finish(self) -> Optional[Dict]:
        if self._prof is not None and self.result is None:
            self.result = reduce_events(_events(self._prof))
            self._prof = None
        return self.result


def _events(prof) -> List[Tuple[str, bool, int, int]]:
    """(name, on_device, start ns, end ns) of every event of the trace."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        start, end = e.start_ns(), e.end_ns()
        if end > start:
            out.append((e.name(), e.device_type() == DeviceType.CUDA,
                        start, end))
    return out


def short_name(name: str, width: int = 96) -> str:
    return name if len(name) <= width else name[:width]


def edges(events: List[Tuple[str, bool, int, int]]) -> Tuple[int, int]:
    """The sub-window's opening and close on the trace's clock: the start
    of the first CUDA runtime call and the end of the last
    ``cudaDeviceSynchronize``."""
    calls = [(s, e, n) for n, d, s, e in events
             if not d and n.startswith("cuda")]
    syncs = [e for s, e, n in calls if n == "cudaDeviceSynchronize"]
    if not calls or not syncs:
        raise ValueError("the trace holds no CUDA runtime call or no "
                         "cudaDeviceSynchronize to bound its sub-window")
    return min(s for s, _, _ in calls), max(syncs)


def reduce_events(events: List[Tuple[str, bool, int, int]]) -> Dict:
    """The reduction of a trace over the sub-window that ``edges`` reads
    from it."""
    start_ns, stop_ns = edges(events)
    dev = sorted({(n, max(s, start_ns), min(e, stop_ns))
                  for n, d, s, e in events
                  if d and min(e, stop_ns) > max(s, start_ns)},
                 key=lambda t: t[1])
    host = sorted(((s, e, n) for n, d, s, e in events if not d))
    kernel_s: Dict[str, float] = {}
    launches: Dict[str, int] = {}
    busy_ns, reach, gaps = 0, start_ns, []
    for name, s, e in dev:
        kernel_s[name] = kernel_s.get(name, 0.0) + (e - s) / 1e9
        launches[name] = launches.get(name, 0) + 1
        if s > reach:
            gaps.append((s - reach, reach, s))
        busy_ns += max(0, e - max(s, reach))
        reach = max(reach, e)
    if stop_ns > reach:
        gaps.append((stop_ns - reach, reach, stop_ns))
    gaps.sort(reverse=True)
    starts = [h[0] for h in host]
    named = []
    for length, g0, g1 in gaps[:10]:
        mid = (g0 + g1) // 2
        label = "no host event"
        best = None
        # innermost host event around the gap's middle, among those that
        # started within the gap's reach (a bounded look back)
        i = bisect.bisect_right(starts, mid)
        for s, e, n in reversed(host[max(0, i - 2000):i]):
            if e >= mid and (best is None or e - s < best[1] - best[0]):
                best = (s, e, n)
        if best is not None:
            label = short_name(best[2])
        named.append([label, length / 1e9])
    top = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (stop_ns - start_ns) / 1e9, "busy_s": busy_ns / 1e9,
            "kernel_s": kernel_s, "launches": launches,
            "device_ops": [[short_name(n), s] for n, s in top],
            "idle_gaps": named}


def matching(red: Dict, pattern) -> Tuple[float, int]:
    """Device seconds and launches of the kernels whose name matches the
    compiled regex ``pattern``."""
    secs, n = 0.0, 0
    for name, s in red["kernel_s"].items():
        if pattern.search(name):
            secs += s
            n += red["launches"][name]
    return secs, n
