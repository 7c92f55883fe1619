"""The harness: its JAX guard by whole top-level names, the modules a run
loads, a cell, traffic and metric added as files alone, and the refusal
to run without a card or without the program."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

from bench_gpu import harness

ROOT = harness.ROOT


def _scrubbed_env(extra_path=()):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(str(p) for p in extra_path)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_guard_compares_whole_top_level_names(monkeypatch):
    fake = {"diffusionmodel_tpu_torch.serving": 1, "jaxtyping": 1,
            "flaxen": 1, "optaxy": 1}
    for name in fake:
        monkeypatch.setitem(sys.modules, name, object())
    assert harness.banned_loaded() == []
    monkeypatch.setitem(sys.modules, "diffusionmodel_tpu.nn", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert harness.banned_loaded() == ["diffusionmodel_tpu.nn", "jaxlib"]


def test_run_loads_no_jax():
    """Every module a run loads (the harness, the drivers, the families,
    the readers, the reference and the port's entry points) in a fresh
    interpreter; the reference loads nothing of the port."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(ROOT)!r})
        import bench_gpu.reference.context_unet, bench_gpu.reference.diffusion
        import bench_gpu.reference.lowp
        port = [m for m in sys.modules if m.split('.')[0]
                == 'diffusionmodel_tpu_torch']
        assert not port, port
        from bench_gpu import harness, trace, traffic, roofline, calibrate
        import bench_gpu.run
        spec = harness.load_spec()
        for w in spec['workloads']:
            cell = harness.find_cell(spec, w['name'], True)
            harness.driver(cell), harness.family(cell.config)
            e2e = harness.metrics_for(spec, w['name'], False)
            for m in e2e + cell.metrics:
                harness.reader(m['name'])
        import diffusionmodel_tpu_torch.serving, diffusionmodel_tpu_torch.train
        import diffusionmodel_tpu_torch.nn.factory
        bad = harness.banned_loaded()
        assert not bad, bad
        print('ok')
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_scrubbed_env(), timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_no_card_means_no_result():
    out = subprocess.run(
        [sys.executable, str(ROOT / "bench_gpu" / "run.py"), "--workload",
         "ctxunet-serve-dpmpp20", "--seed", str(2 ** 35), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True,
        env=_scrubbed_env(), timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def _bench_only_copy(dst):
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench_gpu", dst / "bench_gpu",
                    ignore=shutil.ignore_patterns("__pycache__"))


def test_benchmark_alone_runs_nothing(tmp_path):
    """A directory that holds only BENCHMARK.json and bench_gpu: no
    program, so no result, even past the look for a card."""
    _bench_only_copy(tmp_path)
    code = textwrap.dedent(f"""
        import sys, torch
        sys.path.insert(0, {str(tmp_path)!r})
        from bench_gpu import harness
        import bench_gpu.run as run
        cell = harness.find_cell(harness.load_spec(), 'ctxunet-serve-dpmpp20',
                                 False)
        sys.exit(run.run(cell, 3, 1.0, False, torch.device('cpu')))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_scrubbed_env(), timeout=120,
                         cwd=tmp_path)
    assert out.returncode != 0
    assert "diffusionmodel_tpu_torch" in out.stderr
    assert out.stdout.strip() == ""


def test_a_new_cell_and_metric_are_files_alone(tmp_path):
    """A later cell (a new traffic mix on the configuration there) and a
    new per-layer metric, added as files and entries only: the harness
    finds them and the run reports the metric."""
    _bench_only_copy(tmp_path)
    b = tmp_path / "bench_gpu"
    mix = json.loads((b / "workloads" / "ctxunet-serve-dpmpp20.json")
                     .read_text())
    mix.update(images_per_request=[1, 2], clients=2, max_batch=2,
               warm_batches=1, program={"sample.dpm_steps": 2})
    (b / "workloads" / "extra-mix.json").write_text(json.dumps(mix))
    (b / "limits" / "extra-cell.json").write_text(json.dumps(
        {"requests": 2, "baseline": "bf16",
         "compared": {"image_gap_over_baseline": 1.0}, "controls": []}))
    (b / "metrics" / "requests_done.extra.py").write_text(
        '"""Requests that returned in the window."""\n\n\n'
        "def read(rec):\n    return len(rec['latencies']) or None\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "extra-cell",
                              "config": "ctxunet_v2_full_bf16",
                              "traffic": "extra-mix", "chips": 1,
                              "why": "a test cell"})
    spec["end_to_end"][0]["workloads"].append("extra-cell")
    spec["per_layer"].append({"name": "requests_done.extra", "unit": "1",
                              "better": "higher",
                              "source": "program_counter", "layer": "batcher",
                              "moves": "images_per_s",
                              "workloads": ["extra-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = textwrap.dedent(f"""
        import json, sys, torch
        sys.path.insert(0, {str(tmp_path)!r})
        from bench_gpu import harness
        import bench_gpu.run as run
        cell = harness.find_cell(harness.load_spec(), 'extra-cell', True)
        cell.config['model'].update(n_feat=16, img_size=32, dtype='float32',
                                    fused_upsample=False)
        print(json.dumps([m['name'] for m in cell.metrics]))
        sys.exit(run.run(cell, 2 ** 36 + 1, 1.5, False, torch.device('cpu')))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_scrubbed_env([ROOT]), timeout=300,
                         cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[0]) == ["requests_done.extra"]
    res = json.loads(lines[-1])
    assert res["correct"] is True
    assert res["metrics"]["requests_done.extra"]["value"] >= 1
    assert res["metrics"]["requests_done.extra"]["unit"] == "1"
    assert list(res)[-1] == "checks"
