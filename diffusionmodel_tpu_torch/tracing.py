"""Spans and counters at the port's layer boundaries.

Recording is off by default and turned on and off from Python alone
(:func:`enable`, :func:`disable`). Off, :func:`span` reads one module
flag and returns a shared no-op, :func:`begin` returns None and
:func:`count` returns at once: no clock read, no lock, nothing kept.

On, each span records its name, its start and end, the thread that
opened it, the span that was open on that thread when it opened (its
parent), its own id, and the ids it was given (``request``: every span of
one request; ``batch``: the batch that carried it). Spans are kept in one
bounded buffer that any thread appends to, and handed out by
:func:`drain` alone; a span past the bound is counted under
``tracing.dropped_spans`` and not kept. Counters hold totals from the
process's start (of what was counted while recording was on); a reader
takes the increments over its window.

Spans come in two kinds:

- :func:`span` is a context manager on the calling thread: it opens on
  entry, closes on exit and is the parent of the spans opened inside it
  on that thread. :func:`span_from` is the same span with a start the
  caller read already, and ``close(end)`` on it sets the end the caller
  reads, where a caller times the same interval for itself.
- :func:`begin` / :func:`end` is a pair for a span that ends on another
  thread (a request queued by its caller and taken by a worker). It is
  the parent of nothing (``nested`` False).

The clock is ``time.time_ns()``: ``CLOCK_REALTIME``, the clock PyTorch's
profiler stamps its events with (``c10::getTime``), so a span and the
CUDA runtime calls made inside it read on one clock.

Spans sit at layer boundaries, and inside a model's forward only at the
LDM UNet's SpatialTransformers (``ldm.transformer``, with the counters
``ldm.attn_flash_calls`` / ``ldm.attn_plain_calls``): a forward that
``torch.utils.checkpoint`` recomputes (``fit_ldm``'s remat) records those
again.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

LIMIT = 1 << 18  # spans kept between two drains
DROPPED = "tracing.dropped_spans"

now = time.time_ns

_on = False
_lock = threading.Lock()
_spans: List["Span"] = []
_counts: Dict[str, int] = {}
_ids = itertools.count(1)
_local = threading.local()


class Span(NamedTuple):
    name: str
    start: int  # ns, time.time_ns()
    end: int
    thread: int  # threading.get_native_id() of the opening thread
    parent: Optional[int]  # id of the span open on that thread, if any
    id: int
    ids: Dict[str, object]
    nested: bool  # opened by span() / span_from(), not begin()


class _Noop:
    """What :func:`span` and :func:`span_from` return while off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def close(self, end: int) -> None:
        pass


NOOP = _Noop()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _keep(span: Span) -> None:
    with _lock:
        if len(_spans) < LIMIT:
            _spans.append(span)
        else:
            _counts[DROPPED] = _counts.get(DROPPED, 0) + 1


class _Open:
    """A span being recorded."""

    __slots__ = ("name", "ids", "start", "end", "thread", "parent", "id",
                 "nested")

    def __init__(self, name: str, ids: Dict, start: Optional[int],
                 nested: bool):
        self.name, self.ids, self.start, self.end = name, ids, start, None
        self.nested = nested
        self.id = next(_ids)
        self.thread = threading.get_native_id()
        st = _stack()
        self.parent = st[-1] if st else None

    def __enter__(self):
        _stack().append(self.id)
        if self.start is None:
            self.start = now()
        return self

    def __exit__(self, *exc):
        end = self.end if self.end is not None else now()
        _stack().pop()
        self._record(end)
        return False

    def close(self, end: int) -> None:
        """Sets the end to ``end`` (a reading of :func:`now`)."""
        self.end = end

    def _record(self, end: int) -> None:
        _keep(Span(self.name, self.start, end, self.thread, self.parent,
                   self.id, self.ids, self.nested))


def span(name: str, **ids):
    """``with span(name, **ids):`` records the block as a span."""
    if not _on:
        return NOOP
    return _Open(name, ids, None, True)


def span_from(start: int, name: str, **ids):
    """:func:`span` opened at ``start``, a reading of :func:`now`."""
    if not _on:
        return NOOP
    return _Open(name, ids, start, True)


def begin(name: str, **ids) -> Optional[_Open]:
    """Opens a span that :func:`end` closes, on any thread; None while
    off."""
    if not _on:
        return None
    return _Open(name, ids, now(), False)


def end(opened: Optional[_Open], at: Optional[int] = None, **ids) -> None:
    """Closes what :func:`begin` returned, at ``at`` (default now), adding
    ``ids`` to its own."""
    if opened is None:
        return
    if ids:
        opened.ids = {**opened.ids, **ids}
    opened._record(now() if at is None else at)


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name``."""
    if not _on:
        return
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def drain() -> Tuple[List[Span], Dict[str, int]]:
    """The spans recorded since the last drain (which leave the buffer)
    and the counters' totals."""
    global _spans
    with _lock:
        spans, _spans = _spans, []
        return spans, dict(_counts)


def write_json(path: str) -> None:
    """Drains the recorder into ``path``: the spans (times in ns on the
    profiler's clock; a Chrome trace that PyTorch exports shows an event
    at ``(ns - baseTimeNanoseconds) / 1000`` microseconds) and the
    counters' totals."""
    spans, counts = drain()
    with open(path, "w") as f:
        json.dump({"clock": "time.time_ns",
                   "spans": [s._asdict() for s in spans],
                   "counters": counts}, f)
