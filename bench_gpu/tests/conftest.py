"""Fixtures of the benchmark's tests: ``python -m pytest bench_gpu/tests``.

Tests that need the card carry the ``cuda`` marker and take the ``cuda``
fixture, which skips without a card: the look happens when the test runs,
never while the module is imported.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips "
                            "without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny_cell():
    """A cell of BENCHMARK.json at a size the CPU runs in seconds: n_feat
    16 at 32 px in float32 (the port's float32 path and the reference agree
    to rounding there), with the traffic shrunk alike."""
    from bench_gpu import harness

    spec = harness.load_spec()

    def make(name, trace=False, **traffic):
        cell = harness.find_cell(spec, name, trace)
        cfg = cell.config
        if cfg["family"] == "context_unet":
            cfg["model"].update(n_feat=16, img_size=32, dtype="float32",
                                fused_upsample=False)
            cfg["train"].update(moment_dtype="float32")
        else:  # the runner's "tiny" architecture, 64 px
            cfg.update(arch="tiny", image_size=64)
            cfg["unet"].update(channels=32, channel_multipliers=[1, 2],
                               attention_levels=[0], n_res_blocks=1,
                               n_heads=2, d_cond=64)
            cfg["autoencoder"].update(channels=32, ch_mults=[1, 1, 2, 2])
            cell.traffic.update(size=64)
        cell.traffic.update(traffic)
        return cell

    return make
