#!/usr/bin/env python3
"""Benchmark cells with the program's spans read beside the device trace,
and what recording the spans costs. One card.

    python3 tools/span_probe.py run --workload W --seed N [--seconds S]
    python3 tools/span_probe.py cost --workload W --seed N --pairs K \\
        [--seconds S]

``run``: one run of ``bench_gpu/run.py --trace 1`` as the benchmark makes
it, with ``bench_gpu.spans.SpanTracer`` in the place of ``trace.Tracer``
and the per-layer metrics that read the spans (``PENDING``, the entries a
``BENCHMARK.json`` would list for them) added to the cell's. Prints the
result line; to standard error, the share of the sub-window's busy time
attributed to program spans, the device seconds by span, the spans
that lie wholly in the sub-window, and the counters' increments, with
``conv.per_sample_calls`` and ``group_norm.fused_calls`` also per image
returned.

``--gc`` (with ``run``) also times Python's garbage collections and
names, for each of the ten longest idle gaps, those that overlap it.

``cost``: one set-up and warm-up, then ``2K`` windows of ``--seconds`` in
turns with the recorder off and on (off, on, on, off, ...), the profiler
off and no check; one JSON line a window with its end-to-end metrics.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from bench_gpu import harness  # noqa: E402

SERVE, TRAIN = "ctxunet-serve-dpmpp20", "ctxunet-train-bf16"
GEN, LDM_TRAIN = "sd-txt2img-dpmpp20", "sd-train-512"
PENDING = [
    {"name": "queue_wait_p90_s.serve", "unit": "s", "better": "lower",
     "source": "program_counter", "layer": "batcher (serving.SamplerService)",
     "moves": "request_p90_s", "workloads": [SERVE]},
    {"name": "conv_calls_per_image.serve", "unit": "calls",
     "better": "lower", "source": "program_counter",
     "layer": "per-sample convolutions (kernels.per_sample_conv)",
     "moves": "images_per_s", "workloads": [SERVE]},
    {"name": "feed_ms.train", "unit": "ms", "better": "lower",
     "source": "program_counter", "layer": "train steps: feed",
     "moves": "trained_images_per_s", "workloads": [TRAIN]},
    {"name": "optimizer_ms.train", "unit": "ms", "better": "lower",
     "source": "device_trace", "layer": "train steps: optimizer",
     "moves": "trained_images_per_s", "workloads": [TRAIN, LDM_TRAIN]},
    {"name": "vae_decode_ms.gen", "unit": "ms", "better": "lower",
     "source": "device_trace", "layer": "LDM pipeline: VAE decode",
     "moves": "images_per_s", "workloads": [GEN]},
]


# counters printed per image returned: per-sample convolution calls (each
# adds its batch size) and GroupNorm + activation kernel calls (each adds 1)
PER_IMAGE = ("conv.per_sample_calls", "group_norm.fused_calls")


def _with_pending(load):
    def load_spec():
        spec = load()
        spec["per_layer"] = spec["per_layer"] + PENDING
        return spec
    return load_spec


def _report(read):
    def read_metrics(cell, rec):
        t = rec.get("trace") or {}
        if "span_s" in t:
            top = sorted(t["span_s"].items(), key=lambda kv: -kv[1])
            counts, images = t["program"]["counters"], rec.get("images")
            print("spans " + json.dumps({
                "attributed_share": t["attributed_s"] / t["busy_s"],
                "attributed_s": t["attributed_s"], "busy_s": t["busy_s"],
                "span_s": dict(top),
                "whole": t["whole"],
                "counters": counts,
                "per_image": {k: counts[k] / images for k in PER_IMAGE
                              if images and k in counts},
                "gc_gaps": t.get("gc_gaps"), "gc_ms": t.get("gc_ms"),
                "host_s": {k: [len(v), sum(v)] for k, v in
                           t["program"]["durations"].items()}}),
                file=sys.stderr)
        return read(cell, rec)
    return read_metrics


def _with_gc_pauses(reduce):
    """``reduce_with_spans`` that also names, for each of the ten longest
    idle gaps, the garbage collections (generation, ms) that overlap it."""
    pauses = []
    t0 = [0]

    def on_gc(phase, info):
        if phase == "start":
            t0[0] = time.time_ns()
        else:
            pauses.append((t0[0], time.time_ns(), info["generation"]))

    gc.callbacks.append(on_gc)

    def reduce_with_spans(events, spans_, counts0, counts1):
        from bench_gpu import spans, trace

        red = reduce(events, spans_, counts0, counts1)
        plain = [e[:4] for e in events]
        start, stop = trace.edges(plain)
        red["gc_gaps"] = [
            [g / 1e6, [[gen, (e - s) / 1e6] for s, e, gen in pauses
                       if s < g1 and e > g0]]
            for g, g0, g1 in spans.gap_intervals(plain, start, stop)]
        inside = [(e - s) / 1e6 for s, e, _ in pauses
                  if start <= s and e <= stop]
        red["gc_ms"] = {"n": len(inside), "total": sum(inside),
                        "max": max(inside, default=0.0)}
        return red
    return reduce_with_spans


def run(args) -> int:
    from bench_gpu import run as bench_run, spans, trace

    trace.Tracer = spans.SpanTracer
    if args.gc:
        spans.reduce_with_spans = _with_gc_pauses(spans.reduce_with_spans)
    harness.load_spec = _with_pending(harness.load_spec)
    harness.read_metrics = _report(harness.read_metrics)
    return bench_run.main(["--workload", args.workload, "--seed",
                           str(args.seed), "--seconds", str(args.seconds),
                           "--trace", "1"])


def cost(args) -> int:
    import torch

    from diffusionmodel_tpu_torch import tracing

    harness.prepare_env()
    cell = harness.find_cell(harness.load_spec(), args.workload, False)
    dev = torch.device("cuda", 0)
    sess = harness.driver(cell).Session(cell, args.seed, dev)
    sess.warm()
    torch.cuda.synchronize(dev)
    for i in range(2 * args.pairs):
        on = i % 4 in (1, 2)
        if on:
            tracing.enable()
        rec = sess.window(args.seconds, None)
        tracing.disable()
        kept, _ = tracing.drain()
        m = harness.read_metrics(cell, rec)
        print(json.dumps({"window": i, "spans": on, "kept": len(kept),
                          **{k: v["value"] for k, v in m.items()}}),
              flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("mode", choices=("run", "cost"))
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--pairs", type=int, default=3)
    p.add_argument("--gc", action="store_true",
                   help="run: time Python's garbage collections and name "
                        "those that overlap the longest idle gaps")
    args = p.parse_args(argv)
    return run(args) if args.mode == "run" else cost(args)


if __name__ == "__main__":
    sys.exit(main())
