"""The program's spans and counters read beside the device trace.

The port records spans and counters at its layer boundaries
(``diffusionmodel_tpu_torch.tracing``, off unless a caller turns it on).
:class:`SpanTracer` is ``trace.Tracer`` with that recorder on from the
window's opening to its close: ``start()`` turns it on, ``finish()`` (once
the window has closed) drains it and turns it off. Its reduction is
``trace.reduce_events``'s, every key of it as that gives it, with:

- ``idle_gaps``: the same ten gaps, each named by the innermost program
  span that covers its middle, then the CUDA runtime call that covers it
  too (``train.feed/cudaMemcpyAsync``), either alone, or ``no host
  event``;
- ``span_s``: device seconds of the sub-window's operations by the
  innermost program span that holds their launching runtime call (the
  kineto correlation id links an operation to its call);
- ``attributed_s``: the seconds of ``busy_s`` in which an operation so
  attributed ran;
- ``whole``: for each span name, over the spans that lie wholly in the
  sub-window, their number ``n``, the device seconds of the operations
  launched inside them or their child spans (``device_s``) and the sum of
  their ``images`` ids;
- ``program``: over the whole window, each span name's host durations
  (``durations``, seconds) and the counters' increments (``counters``).

A span and the runtime calls read on one clock: the recorder stamps with
``time.time_ns()``, the clock the profiler's events carry.

Without the recorder (a program that lacks it) the tracer is
``trace.Tracer`` and its reduction has none of these keys.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Tuple

from bench_gpu.trace import Tracer, edges, reduce_events, short_name

NO_HOST = "no host event"


def _recorder():
    try:
        from diffusionmodel_tpu_torch import tracing
    except ImportError:
        return None
    return tracing


class SpanTracer(Tracer):
    def __init__(self):
        super().__init__()
        self._rec = _recorder()
        self._counts0: Dict[str, int] = {}

    def start(self) -> None:
        if self._rec is not None:
            _, self._counts0 = self._rec.drain()
            self._rec.enable()
        super().start()

    def finish(self) -> Optional[Dict]:
        if self._prof is not None and self.result is None:
            events = linked_events(self._prof)
            self._prof = None
            if self._rec is None:
                self.result = reduce_events([e[:4] for e in events])
            else:
                spans, counts = self._rec.drain()
                self._rec.disable()
                self.result = reduce_with_spans(events, spans,
                                                self._counts0, counts)
        return self.result


def linked_events(prof) -> List[Tuple]:
    """(name, on_device, start ns, end ns, correlation id, linked
    correlation id, thread) of every event of the trace, in the order and
    with the filter of ``trace._events``."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        start, end = e.start_ns(), e.end_ns()
        if end > start:
            out.append((e.name(), e.device_type() == DeviceType.CUDA,
                        start, end, e.correlation_id(),
                        e.linked_correlation_id(), e.start_thread_id()))
    return out


class SpanIndex:
    """The innermost span at a time, on one thread or on any. Spans opened
    on one thread nest, so the innermost span holding ``t`` on a thread is
    the last one opened there by ``t`` or one of its ancestors."""

    def __init__(self, spans: Iterable):
        self.by_id = {s.id: s for s in spans}
        self.threads: Dict[int, Tuple[List[int], List]] = {}
        for s in sorted(self.by_id.values(), key=lambda s: s.start):
            starts, ss = self.threads.setdefault(s.thread, ([], []))
            starts.append(s.start)
            ss.append(s)

    def _on(self, thread: int, t: int):
        starts, ss = self.threads[thread]
        i = bisect.bisect_right(starts, t)
        s = ss[i - 1] if i else None
        while s is not None and s.end < t:
            s = self.by_id.get(s.parent)
        return s

    def innermost(self, t: int, thread: Optional[int] = None):
        """On ``thread`` when spans were opened there, else the shortest
        holding ``t`` on any thread."""
        if thread in self.threads:
            return self._on(thread, t)
        best = None
        for th in self.threads:
            s = self._on(th, t)
            if s is not None and (best is None
                                  or s.end - s.start < best.end - best.start):
                best = s
        return best

    def lineage(self, s):
        while s is not None:
            yield s
            s = self.by_id.get(s.parent)


def _union(intervals: List[Tuple[int, int]]) -> int:
    total, reach = 0, None
    for s, e in sorted(intervals):
        if reach is None or s > reach:
            total += e - s
            reach = e
        elif e > reach:
            total += e - reach
            reach = e
    return total


def gap_intervals(events, start_ns: int, stop_ns: int
                  ) -> List[Tuple[int, int, int]]:
    """The ten longest (length, start, end) gaps between device operations
    in the sub-window, as ``reduce_events`` finds them."""
    dev = sorted({(n, max(s, start_ns), min(e, stop_ns))
                  for n, d, s, e in events
                  if d and min(e, stop_ns) > max(s, start_ns)},
                 key=lambda t: t[1])
    reach, gaps = start_ns, []
    for _, s, e in dev:
        if s > reach:
            gaps.append((s - reach, reach, s))
        reach = max(reach, e)
    if stop_ns > reach:
        gaps.append((stop_ns - reach, reach, stop_ns))
    gaps.sort(reverse=True)
    return gaps[:10]


def _runtime_call_at(host: List[Tuple[int, int, str]], starts: List[int],
                     t: int) -> Optional[str]:
    """The innermost host event around ``t`` (``reduce_events``'s look)."""
    best = None
    i = bisect.bisect_right(starts, t)
    for s, e, n in reversed(host[max(0, i - 2000):i]):
        if e >= t and (best is None or e - s < best[1] - best[0]):
            best = (s, e, n)
    return None if best is None else best[2]


def reduce_with_spans(events: List[Tuple], spans: List, counts0: Dict,
                      counts1: Dict) -> Dict:
    """``reduce_events`` of the trace, with the program's spans read
    against it (the module docstring lists the keys)."""
    plain = [e[:4] for e in events]
    red = reduce_events(plain)
    start_ns, stop_ns = edges(plain)
    nested = SpanIndex(s for s in spans if s.nested)
    host = sorted((s, e, n) for n, d, s, e, *_ in events if not d)
    host_starts = [h[0] for h in host]

    calls = {}
    for n, d, s, e, corr, _, thread in events:
        if not d and corr:
            calls[corr] = (s, thread)
    span_ns: Dict[str, int] = {}
    inclusive: Dict[int, int] = {}
    attributed = []
    for n, d, s, e, corr, linked, _ in events:
        s, e = max(s, start_ns), min(e, stop_ns)
        if not d or e <= s:
            continue
        call = calls.get(corr) or calls.get(linked)
        inner = None if call is None else nested.innermost(*call)
        if inner is None:
            continue
        span_ns[inner.name] = span_ns.get(inner.name, 0) + (e - s)
        for a in nested.lineage(inner):
            inclusive[a.id] = inclusive.get(a.id, 0) + (e - s)
        attributed.append((s, e))

    whole: Dict[str, Dict] = {}
    for sp in nested.by_id.values():
        if sp.start >= start_ns and sp.end <= stop_ns:
            w = whole.setdefault(sp.name, {"n": 0, "device_s": 0.0,
                                           "images": 0})
            w["n"] += 1
            w["device_s"] += inclusive.get(sp.id, 0) / 1e9
            w["images"] += int(sp.ids.get("images", 0))

    named = []
    for length, g0, g1 in gap_intervals(plain, start_ns, stop_ns):
        mid = (g0 + g1) // 2
        sp = nested.innermost(mid)
        call = _runtime_call_at(host, host_starts, mid)
        parts = [p for p in (sp and sp.name, call and short_name(call)) if p]
        named.append(["/".join(parts) if parts else NO_HOST, length / 1e9])

    durations: Dict[str, List[float]] = {}
    for sp in spans:
        durations.setdefault(sp.name, []).append((sp.end - sp.start) / 1e9)
    red.update({
        "idle_gaps": named,
        "span_s": {k: v / 1e9 for k, v in span_ns.items()},
        "attributed_s": _union(attributed) / 1e9,
        "whole": whole,
        "program": {
            "durations": durations,
            "counters": {k: v - counts0.get(k, 0) for k, v in counts1.items()
                         if v != counts0.get(k, 0)}},
    })
    return red


def program(rec: Dict) -> Optional[Dict]:
    """The run's program spans and counters, or None where it has none."""
    t = rec.get("trace")
    return None if not t else t.get("program")


def whole_device_ms(rec: Dict, name: str, per: str = "n") -> Optional[float]:
    """Device ms of the spans ``name`` that lie wholly in the sub-window,
    per span (``per="n"``) or per image (``per="images"``)."""
    t = rec.get("trace") or {}
    w = (t.get("whole") or {}).get(name)
    if not w or not w[per]:
        return None
    return 1e3 * w["device_s"] / w[per]
