"""The program's spans read beside the device trace (``bench_gpu/spans.py``)
and the readers of the metrics they feed. The card test checks that a span
around a launch holds that launch's runtime call on the trace's clock:

    python -m pytest bench_gpu/tests/test_bench_spans.py -m cuda -s
"""

import time

import pytest

from bench_gpu import harness, spans
from bench_gpu.trace import reduce_events
from diffusionmodel_tpu_torch import tracing
from diffusionmodel_tpu_torch.tracing import Span

MS = 1_000_000
T = 7  # the launching thread


def _span(name, start, end, id, parent=None, nested=True, **ids):
    return Span(name, start * MS, end * MS, T, parent, id, ids, nested)


def _events():
    """A 100 ms sub-window: a training step whose feed copies and waits,
    a forward launched under ``train.fwd_bwd`` and an update under
    ``train.optimizer``; one kernel whose launch lies in no span."""
    ev = [
        ("cudaMemcpyAsync", False, 1 * MS, 20 * MS, 11, 0, T),
        ("Memcpy HtoD (Pageable -> Device)", True, 18 * MS, 20 * MS, 11, 0,
         0),
        ("cudaLaunchKernel", False, 21 * MS, 22 * MS, 12, 0, T),
        ("fwd_kernel", True, 22 * MS, 50 * MS, 12, 0, 0),
        ("cudaLaunchKernel", False, 51 * MS, 52 * MS, 13, 0, T),
        # the kernel names its call through the linked id alone
        ("adam_kernel", True, 60 * MS, 70 * MS, 0, 13, 0),
        ("cudaStreamSynchronize", False, 75 * MS, 90 * MS, 0, 0, T),
        ("cudaLaunchKernel", False, 90 * MS, 91 * MS, 14, 0, T),
        ("stray_kernel", True, 91 * MS, 92 * MS, 14, 0, 0),
        ("cudaDeviceSynchronize", False, 92 * MS, 100 * MS, 0, 0, T),
    ]
    sp = [
        _span("train.step", 1, 75, 1),
        _span("train.feed", 1, 20, 2, parent=1),
        _span("train.fwd_bwd", 20, 50, 3, parent=1),
        _span("train.optimizer", 50, 53, 4, parent=1),
        _span("serve.queue", 0, 95, 5, nested=False, request=0),
    ]
    return ev, sp


def test_kernels_go_to_the_span_of_their_launch_and_gaps_are_named():
    ev, sp = _events()
    red = spans.reduce_with_spans(ev, sp, {"c": 1}, {"c": 4, "d": 2})
    assert red["span_s"] == pytest.approx(
        {"train.feed": 0.002, "train.fwd_bwd": 0.028,
         "train.optimizer": 0.010})
    assert red["attributed_s"] == pytest.approx(0.040)
    assert red["busy_s"] == pytest.approx(0.041)
    # the optimizer's kernel ran after its span closed and is still its
    w = red["whole"]
    assert w["train.optimizer"] == {"n": 1, "device_s": pytest.approx(0.010),
                                    "images": 0}
    assert w["train.step"]["device_s"] == pytest.approx(0.040)
    gaps = dict((label, s) for label, s in red["idle_gaps"])
    assert gaps == pytest.approx({
        "train.feed/cudaMemcpyAsync": 0.017,
        "train.fwd_bwd/cudaLaunchKernel": 0.002,
        "train.step": 0.010,  # 50-60 ms, after the optimizer's span
        "cudaStreamSynchronize": 0.021,  # 70-91 ms, outside the step
        "cudaDeviceSynchronize": 0.008})
    assert red["program"]["counters"] == {"c": 3, "d": 2}
    assert red["program"]["durations"]["serve.queue"] == [pytest.approx(
        0.095)]


def test_the_plain_keys_are_those_of_the_plain_reduction():
    ev, sp = _events()
    plain = reduce_events([e[:4] for e in ev])
    for with_spans in (sp, []):
        red = spans.reduce_with_spans(ev, with_spans, {}, {})
        for key in ("window_s", "busy_s", "kernel_s", "launches",
                    "device_ops"):
            assert red[key] == plain[key], key
        assert [s for _, s in red["idle_gaps"]] == \
            [s for _, s in plain["idle_gaps"]]
    red = spans.reduce_with_spans(ev, [], {}, {})
    assert [label for label, _ in red["idle_gaps"]] == \
        [label for label, _ in plain["idle_gaps"]]


def test_launches_follow_their_thread():
    """Two threads' spans overlap in time: a launch goes to its own
    thread's span; a gap, which has no thread, to the shorter."""
    a = Span("serve.run", 0, 100 * MS, 1, None, 1, {}, True)
    b = Span("other", 40 * MS, 60 * MS, 2, None, 2, {}, True)
    idx = spans.SpanIndex([a, b])
    assert idx.innermost(50 * MS, 1) is a
    assert idx.innermost(50 * MS, 2) is b
    assert idx.innermost(50 * MS) is b
    assert idx.innermost(50 * MS, 99) is b  # a thread the spans do not name
    assert idx.innermost(70 * MS, 2) is None


def _reader(name):
    return harness.reader(name).read


READS = {"queue_wait_p90_s.serve", "conv_calls_per_image.serve",
         "feed_ms.train", "optimizer_ms.train", "vae_decode_ms.gen"}


def test_readers_read_a_planted_record():
    waits = [i / 100 for i in range(1, 101)]
    rec = {"images": 40, "trace": {
        "whole": {"train.optimizer": {"n": 4, "device_s": 0.2, "images": 0},
                  "ldm.decode": {"n": 1, "device_s": 0.5, "images": 2}},
        "program": {"counters": {"conv.per_sample_calls": 3400},
                    "durations": {"serve.queue": waits,
                                  "train.step": [1.0] * 4,
                                  "train.feed": [0.01] * 16}}}}
    got = {m: _reader(m)(rec) for m in READS}
    assert got == pytest.approx({
        "queue_wait_p90_s.serve": 0.901, "conv_calls_per_image.serve": 85.0,
        "feed_ms.train": 40.0, "optimizer_ms.train": 50.0,
        "vae_decode_ms.gen": 250.0})


@pytest.mark.parametrize("rec", [
    {}, {"trace": None, "images": 8},
    # a trace from a program without spans: the plain reduction
    {"images": 8, "trace": {"window_s": 1.0, "busy_s": 0.5, "kernel_s": {},
                            "launches": {}, "device_ops": [],
                            "idle_gaps": []}},
    {"images": 8, "trace": {"whole": {}, "program": {"counters": {},
                                                     "durations": {}}}},
])
def test_readers_find_nothing_in_an_empty_record(rec):
    assert {m: _reader(m)(rec) for m in READS} == dict.fromkeys(READS)


@pytest.mark.parametrize("recorder", [True, False])
def test_tracer_reduces_once_the_window_has_closed(monkeypatch, recorder):
    """With the recorder, ``finish()`` drains it and turns it off; on a
    program without one (a parent commit) it is the plain reduction."""
    ev, _ = _events()
    monkeypatch.setattr(spans, "linked_events", lambda prof: ev)
    if not recorder:
        monkeypatch.setattr(spans, "_recorder", lambda: None)
    tr = spans.SpanTracer()
    monkeypatch.setattr(spans.Tracer, "start", lambda self: None)
    tr.start()
    with tracing.span("train.step"):
        pass
    tr._prof = object()  # what Tracer.start() leaves
    red = tr.finish()
    assert tr.finish() is red
    plain = reduce_events([e[:4] for e in ev])
    if recorder:
        assert red["program"]["durations"].keys() == {"train.step"}
        assert tracing.span("x") is tracing.NOOP
    else:
        assert red == plain


@pytest.mark.cuda
def test_a_span_holds_its_launch_on_the_trace_clock(cuda):
    """Each of 50 spans around one launch, made on a thread of its own,
    holds that launch's ``cudaLaunchKernel`` on the trace's clock, and the
    kernel goes to the span. Prints the slack on either side: the two
    clocks differ by no more than the smaller of the two least slacks."""
    import threading

    import torch
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(1 << 20, device=cuda)
    x.add_(1)
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA])
    _, before = tracing.drain()
    tracing.enable()
    prof.start()
    native = []

    def launch():
        native.append(threading.get_native_id())
        for _ in range(50):
            with tracing.span("probe"):
                x.add_(1)
            time.sleep(0.002)

    t = threading.Thread(target=launch)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    torch.cuda.synchronize()
    prof.stop()
    sp, after = tracing.drain()
    tracing.disable()
    events = spans.linked_events(prof)
    launches = sorted((s, e, tid) for n, d, s, e, _, _, tid in events
                      if not d and n == "cudaLaunchKernel")
    probes = sorted((s for s in sp if s.name == "probe"),
                    key=lambda s: s.start)
    assert len(launches) == len(probes) == 50
    lead = [c[0] - p.start for p, c in zip(probes, launches)]
    lag = [p.end - c[1] for p, c in zip(probes, launches)]
    print(f"span clock: launch after span start {min(lead) / 1e3:.3f}-"
          f"{max(lead) / 1e3:.3f} us, span end after launch "
          f"{min(lag) / 1e3:.3f}-{max(lag) / 1e3:.3f} us; thread ids: "
          f"kineto {sorted({c[2] for c in launches})}, native {native}")
    assert min(lead) >= 0 and min(lag) >= 0
    red = spans.reduce_with_spans(events, sp, before, after)
    # the sub-window opens at the first runtime call, inside the first span
    assert red["whole"]["probe"]["n"] == 49
    assert red["span_s"]["probe"] == pytest.approx(
        sum(red["kernel_s"].values()), rel=1e-6)
    assert red["attributed_s"] == pytest.approx(red["busy_s"], rel=1e-6)
