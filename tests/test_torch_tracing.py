"""The port's span and counter recorder (``diffusionmodel_tpu_torch.tracing``)
at its layer boundaries: serving, the train steps, txt2img, the per-sample
convolutions and ``fit``'s profiled epoch (CPU, tiny models)."""

import json
import sys
import threading
from collections import Counter

import numpy as np
import pytest
import torch

from diffusionmodel_tpu_torch import tracing
from diffusionmodel_tpu_torch.config import preset
from diffusionmodel_tpu_torch.diffusion import Schedule
from diffusionmodel_tpu_torch.nn import build_model
from diffusionmodel_tpu_torch.nn.blocks import Conv2d
from diffusionmodel_tpu_torch.serving import SamplerService
from diffusionmodel_tpu_torch.train import create_train_state, make_train_step

torch.set_num_threads(2)

TINY = {"model.n_feat": 8, "model.img_size": 32, "model.n_classes": 3,
        "diffusion.n_T": 10, "sample.dpm_steps": 4}


@pytest.fixture(autouse=True)
def recorder():
    """Recording off and the buffer empty around each test."""
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


def _parts(cfg):
    torch.manual_seed(0)
    model = build_model(cfg.model, cfg.diffusion.high_thresh, device="cpu")
    dc = cfg.diffusion
    return model, Schedule.create(dc.beta1, dc.beta2, dc.n_T, "cpu")


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def _increments(before, after):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def test_off_records_nothing_and_span_is_the_shared_noop():
    assert tracing.span("x") is tracing.NOOP
    assert tracing.span_from(0, "x", batch=1) is tracing.NOOP
    assert tracing.begin("x", request=1) is None
    cfg = preset("full", **TINY)
    model, sched = _parts(cfg)
    _, before = tracing.drain()
    with SamplerService(model, cfg, sched, max_batch=2,
                        sampler="dpmpp") as svc:
        svc.generate([0, 1], seed=3)
    state, opt = create_train_state(model, cfg, 1)
    make_train_step(model, sched, cfg, opt)(state, _wire_batch(0, 2))
    spans, after = tracing.drain()
    assert spans == [] and after == before


def test_serve_queue_ends_when_its_batch_runs():
    """Each request's ``serve.queue`` span ends at the start of the
    ``serve.run`` that carried it and holds that batch's id; each batch's
    spans share its id and its sampler steps sit under its run."""
    cfg = preset("full", **TINY)
    model, sched = _parts(cfg)
    tracing.enable()
    with SamplerService(model, cfg, sched, max_batch=4, sampler="dpmpp",
                        max_wait_ms=50) as svc:
        futs = [svc.submit([i % 3], seed=i) for i in range(6)]
        for f in futs:
            f.result()
    spans, _ = tracing.drain()
    by = _by_name(spans)
    runs = {s.ids["batch"]: s for s in by["serve.run"]}
    queued = by["serve.queue"]
    assert sorted(s.ids["request"] for s in queued) == list(range(6))
    for q in queued:
        run = runs[q.ids["batch"]]
        assert q.end == run.start and q.start <= q.end and not q.nested
    for name in ("serve.collect", "serve.pack", "serve.unpack"):
        assert sorted(s.ids["batch"] for s in by[name]) == sorted(runs)
    steps = Counter(s.parent for s in by["sample.step"])
    assert steps == {r.id: 4 for r in runs.values()}
    assert svc.stats["busy_seconds"] == pytest.approx(
        sum(r.end - r.start for r in runs.values()) / 1e9, rel=0, abs=1e-9)


def _wire_batch(seed, a, b=2):
    rng = np.random.RandomState(seed)
    return {"x": rng.randint(0, 256, (a, b, 32, 32, 3)).astype(np.uint8),
            "c": rng.randint(0, 3, (a, b)).astype(np.int32),
            "mask": rng.randint(0, 3, (a, b, 32, 32)).astype(np.uint8)}


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_spans_once_per_micro_batch(remat):
    """Two micro-batches: two of each per-micro-batch span under one
    ``train.step``, one ``train.optimizer`` and one ``train.ema``; a
    forward recomputed under ``remat`` records nothing more."""
    cfg = preset("full", **TINY, **{
        "train.accum_steps": 2, "train.batch_size": 2,
        "train.ema_decay": 0.9, "train.remat": remat,
        "model.dtype": "bfloat16"})
    model, sched = _parts(cfg)
    state, opt = create_train_state(model, cfg, 1)
    step = make_train_step(model, sched, cfg, opt)
    tracing.enable()
    _, before = tracing.drain()
    step(state, _wire_batch(0, 2))
    spans, after = tracing.drain()
    counts = Counter(s.name for s in spans)
    assert counts == {"train.step": 1, "train.feed": 2, "train.fwd_bwd": 2,
                      "train.accum": 2, "train.optimizer": 1,
                      "train.ema": 1}
    (top,) = [s for s in spans if s.name == "train.step"]
    assert all(s.parent == top.id for s in spans if s is not top)
    # a training forward keeps one convolution call for the batch
    assert _increments(before, after) == {}


def test_per_sample_conv_counts_the_calls_that_split():
    conv = Conv2d(3, 4, 3, padding=1, compute_dtype=torch.bfloat16)
    x = torch.randn(4, 3, 8, 8)
    tracing.enable()
    _, before = tracing.drain()
    with torch.no_grad():
        conv(x)
        conv(x[:1])  # one sample: not split
    conv(x).float().sum().backward()  # with gradients: one call
    _, after = tracing.drain()
    assert _increments(before, after) == {"conv.per_sample_calls": 4}


def test_txt2img_records_one_decode_and_a_step_per_step():
    from diffusionmodel_tpu_torch.models.latent_diffusion.runner import (
        LdmRunner,
    )

    runner = LdmRunner(arch="tiny", sampler="dpmpp", steps=3, verbose=False,
                       device="cpu", use_clip=False)
    tracing.enable()
    runner.txt2img("a crack", batch_size=2, h=64, w=64)
    spans, _ = tracing.drain()
    by = _by_name(spans)
    # the tiny UNet's 4 SpatialTransformers a denoiser call (level 0's 1
    # down and 2 up at 64 tokens, the middle's at 16), depth 1
    assert Counter(s.name for s in spans) == {
        "ldm.txt2img": 1, "ldm.cond": 2, "ldm.sample": 1, "sample.step": 3,
        "ldm.transformer": 12, "ldm.decode": 1, "ldm.out": 1}
    (top,), (sample,) = by["ldm.txt2img"], by["ldm.sample"]
    assert by["ldm.decode"][0].ids == {"images": 2}
    assert {s.parent for s in by["sample.step"]} == {sample.id}
    steps = {s.id for s in by["sample.step"]}
    assert {s.parent for s in by["ldm.transformer"]} == steps
    assert {(s.ids["tokens"], s.ids["depth"])
            for s in by["ldm.transformer"]} == {(64, 1), (16, 1)}
    assert {s.parent for n in ("ldm.cond", "ldm.sample", "ldm.decode",
                               "ldm.out") for s in by[n]} == {top.id}


def test_spans_and_counts_from_many_threads():
    """Threads that record and count at once lose nothing and nest within
    their own thread."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    tracing.enable()
    n_threads, per = 16, 300
    _, before = tracing.drain()

    def work():
        for _ in range(per):
            with tracing.span("outer"):
                with tracing.span("inner"):
                    tracing.count("work")

    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    spans, after = tracing.drain()
    assert _increments(before, after) == {"work": n_threads * per}
    assert len(spans) == 2 * n_threads * per
    outer = {s.id: s for s in spans if s.name == "outer"}
    for s in spans:
        if s.name == "inner":
            p = outer[s.parent]
            assert p.thread == s.thread and p.start <= s.start <= s.end \
                <= p.end


def test_a_full_buffer_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(tracing, "LIMIT", 5)
    tracing.enable()
    _, before = tracing.drain()
    for _ in range(8):
        with tracing.span("x"):
            pass
    spans, after = tracing.drain()
    assert len(spans) == 5
    assert _increments(before, after) == {tracing.DROPPED: 3}


def test_fit_profiled_epoch_writes_spans_on_the_trace_clock(tmp_path):
    """``train.profile_dir``: the epoch's profiler trace and, beside it, the
    spans of its steps, whose times sit on the trace's clock."""
    from diffusionmodel_tpu_torch.data import CrackDataset
    from diffusionmodel_tpu_torch.trainer import fit

    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    data = CrackDataset.from_arrays(images, [(10, 10, 300, 300)] * 8,
                                    [0, 1] * 4, ["a", "b"])
    prof = tmp_path / "prof"
    cfg = preset("full", **{
        **TINY, "model.n_classes": 2, "train.n_epoch": 1,
        "train.batch_size": 2,
        "train.accum_steps": 1, "train.val_split": 0.25,
        "train.eval_every": 0, "train.save_dir": str(tmp_path / "run"),
        "train.profile_dir": str(prof), "train.profile_epoch": 0})
    fit(cfg, dataset=data, device="cpu", verbose=False)
    assert tracing.span("x") is tracing.NOOP  # recording is off again
    trace = json.loads((prof / "trace_ep0.json").read_text())
    spans = json.loads((prof / "spans_ep0.json").read_text())["spans"]
    steps = [s for s in spans if s["name"] == "train.step"]
    assert len(steps) == 3  # 6 training images, 2 a step
    base = trace["baseTimeNanoseconds"]
    ops = [(e["ts"] * 1e3 + base, (e["ts"] + e["dur"]) * 1e3 + base)
           for e in trace["traceEvents"]
           if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    for s in steps:
        inside = [o for o in ops if s["start"] <= o[0] and o[1] <= s["end"]]
        assert inside, s  # the step's operators fall within its span
