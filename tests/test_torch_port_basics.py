"""The PyTorch port's foundations against the JAX package: config presets,
schedules, the import boundary, device resolution, the weight bridge,
checkpoint reading and the CLI's unported modes."""

import ast
import dataclasses
import os
import pickle
import sys
import types
from collections import namedtuple
from pathlib import Path

import numpy as np
import pytest
import torch

from diffusionmodel_tpu.compat.torch_convert import convert_context_unet_v2
from diffusionmodel_tpu.config import preset as jax_preset
from diffusionmodel_tpu.schedules import ddpm_schedules as jax_schedules
from diffusionmodel_tpu_torch.checkpoint import extract_params, load_checkpoint
from diffusionmodel_tpu_torch.compat.flax_bridge import state_dict_from_flax
from diffusionmodel_tpu_torch.config import preset
from diffusionmodel_tpu_torch.device_check import resolve_device
from diffusionmodel_tpu_torch.diffusion import Schedule
from diffusionmodel_tpu_torch.nn import build_model
from diffusionmodel_tpu_torch.nn.context_unet import ContextUnet
from diffusionmodel_tpu_torch.schedules import ddpm_schedules, ddpm_schedules_np

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "diffusionmodel_tpu"}


@pytest.mark.parametrize("name", ["full", "old", "mnist", "custom", "labml",
                                  "generation"])
def test_presets_asdict_equal(name):
    assert dataclasses.asdict(preset(name)) == \
        dataclasses.asdict(jax_preset(name))
    over = {"model.n_feat": 8, "model.use_pallas": True,
            "sample.ddim_steps": 4, "train.co_flip_mask": False}
    assert dataclasses.asdict(preset(name, **over)) == \
        dataclasses.asdict(jax_preset(name, **over))


@pytest.mark.parametrize("betas_T", [(1e-4, 0.02, 700), (1e-4, 0.02, 10),
                                     (2e-4, 0.05, 1000)])
def test_schedule_buffers_bit_equal(betas_T):
    want = {k: np.asarray(v) for k, v in jax_schedules(*betas_T).items()}
    got_np = ddpm_schedules_np(*betas_T)
    got = ddpm_schedules(*betas_T, device="cpu")
    assert set(want) == set(got) == set(got_np)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got_np[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def _port_sources():
    files = sorted((REPO / "diffusionmodel_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_port_imports_no_jax():
    """Static scan: no module of the port, and not chip_smoke.py, imports
    jax, flax, optax, orbax or the JAX package."""
    bad = []
    files = _port_sources()
    assert len(files) > 10
    scanned = {str(f.relative_to(REPO)) for f in files}
    assert {f"diffusionmodel_tpu_torch/{m}.py" for m in (
        "metrics/__init__", "metrics/image_metrics", "metrics/inception",
        "metrics/folder_eval", "data/crop_tool", "data/visualize")} \
        <= scanned
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = [(node.module or "").split(".")[0]]
            elif (isinstance(node, ast.Call)
                  and getattr(node.func, "attr", getattr(node.func, "id", ""))
                  in ("import_module", "__import__") and node.args
                  and isinstance(node.args[0], ast.Constant)):
                roots = [str(node.args[0].value).split(".")[0]]
            else:
                continue
            bad += [f"{path.relative_to(REPO)}:{node.lineno} {r}"
                    for r in roots if r in FORBIDDEN]
    assert not bad, bad


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        Schedule.create(1e-4, 0.02, 10)
    tiny = preset("full", **{"model.n_feat": 8, "model.img_size": 32})
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(tiny.model)
    assert resolve_device("cpu") == torch.device("cpu")


def test_train_and_generate_entry_points_raise_without_cuda(tmp_path):
    """``fit``, ``gen_samples`` and ``cli --mode train|generate`` default
    to CUDA and raise without it; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from diffusionmodel_tpu_torch.cli import main
    from diffusionmodel_tpu_torch.sample import gen_samples
    from diffusionmodel_tpu_torch.trainer import fit

    tiny = preset("full", **{"model.n_feat": 8, "model.img_size": 32})
    with pytest.raises(RuntimeError, match="CUDA"):
        fit(tiny, dataset=object())
    with pytest.raises(RuntimeError, match="CUDA"):
        gen_samples(tiny, str(tmp_path / "ckpt.pkl"))
    for argv in (["--mode", "train"],
                 ["--mode", "generate", "--ckpt", str(tmp_path / "c.pkl")]):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv + ["--data_root", str(tmp_path)])


def test_fp32_compute_sets_and_restores_flags():
    """``fp32_compute`` on a CUDA device turns TF32 off in cuDNN and
    cuBLAS and cuDNN autotuning on, and restores the caller's flags after
    the block, also when it raises; ``autotune=False`` leaves autotuning
    off; on the CPU it changes nothing. (The flags are process settings; a
    CPU build sets them all the same.)"""
    from diffusionmodel_tpu_torch.device_check import fp32_compute

    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul

    def flags():
        return cudnn.allow_tf32, matmul.allow_tf32, cudnn.benchmark

    saved = flags()
    try:
        cudnn.allow_tf32, matmul.allow_tf32, cudnn.benchmark = \
            True, True, False
        with fp32_compute(torch.device("cpu")):
            assert flags() == (True, True, False)
        with pytest.raises(KeyError):
            with fp32_compute(torch.device("cuda")):
                assert flags() == (False, False, True)
                raise KeyError
        assert flags() == (True, True, False)
        cudnn.benchmark = True
        with fp32_compute(torch.device("cuda"), autotune=False):
            assert flags() == (False, False, False)
        assert flags() == (True, True, True)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32, cudnn.benchmark = saved


def test_fp32_compute_deterministic_sets_and_restores_the_flag():
    """``deterministic=True`` holds cuDNN to its deterministic algorithms
    inside the block and restores the caller's setting after it, also when
    it raises; the default leaves a caller's ``True`` in place."""
    from diffusionmodel_tpu_torch.device_check import fp32_compute

    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    try:
        cudnn.deterministic = False
        with fp32_compute(torch.device("cpu"), deterministic=True):
            assert not cudnn.deterministic
        with pytest.raises(KeyError):
            with fp32_compute(torch.device("cuda"), deterministic=True):
                assert cudnn.deterministic
                raise KeyError
        assert not cudnn.deterministic
        with fp32_compute(torch.device("cuda")):
            assert not cudnn.deterministic
        cudnn.deterministic = True
        with fp32_compute(torch.device("cuda")):
            assert cudnn.deterministic
        assert cudnn.deterministic
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


@pytest.mark.parametrize("override, exc", [
    ({"model.fused_upsample": True}, None),  # ported: builds
    ({"model.dtype": "bfloat16"}, None),  # ported: builds
    ({"model.arch": "mnist_unet"}, None),  # ported: builds (side family)
    ({"model.arch": "nope"}, ValueError),
])
def test_build_model_refuses_unported_options(override, exc):
    cfg = preset("full", **{"model.n_feat": 8, "model.img_size": 32},
                 **override)
    if exc is not None:
        with pytest.raises(exc):
            build_model(cfg.model, device="cpu")
        return
    model = build_model(cfg.model, device="cpu")
    if "model.arch" in override:  # another network, with its own layout
        assert model.layout["arch"] == override["model.arch"]
        return
    # what earlier slices refused now builds, computing in the configured
    # type on float32 parameters with the default model's state_dict keys
    plain = build_model(preset("full", **{"model.n_feat": 8,
                                          "model.img_size": 32}).model,
                        device="cpu")
    assert list(model.state_dict()) == list(plain.state_dict())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    want = (torch.bfloat16 if cfg.model.dtype == "bfloat16"
            else torch.float32)
    assert model.dtype == want
    assert model.up4.fused_upsample == cfg.model.fused_upsample
    with torch.no_grad():
        out = model(torch.randn(2, 32, 32, 3), torch.tensor([0, 1]),
                    torch.tensor([0.5, 0.25]), torch.ones(2))
    assert out.shape == (2, 32, 32, 3) and out.dtype == want
    assert torch.isfinite(out.float()).all()


def _randomize(model, seed):
    """Non-trivial BatchNorm statistics and CoordAttn scalars."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.randn(buf.shape, generator=g) * 0.1)
            elif name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=g) + 0.5)
        for name, p in model.named_parameters():
            if name.split(".")[-1] in ("gamma_h", "gamma_w", "alpha", "beta"):
                p.copy_(torch.randn(p.shape, generator=g))


@pytest.mark.parametrize("norm, v1", [("group", False), ("batch", False),
                                      ("group", True)])
def test_bridge_round_trip_bit_exact(norm, v1):
    """port state_dict -> JAX trees (the JAX package's converter) -> port
    state_dict (the bridge) is the identity, bit for bit."""
    torch.manual_seed(0)
    model = ContextUnet(in_ch=3, n_feat=8, n_classes=3, img_size=32,
                        norm=norm, use_local_enhancer=not v1)
    _randomize(model, 1)
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    params, stats = convert_context_unet_v2(sd, norm=norm)
    assert ("local_enhance" in params) is not v1
    back = state_dict_from_flax(params, stats)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].dtype == torch.from_numpy(np.asarray(v)).dtype, k
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    fresh = ContextUnet(in_ch=3, n_feat=8, n_classes=3, img_size=32,
                        norm=norm, use_local_enhancer=not v1)
    fresh.load_state_dict(back)  # strict: every key, every shape


def test_checkpoint_loader_stubs_unknown_classes(tmp_path):
    """A JAX checkpoint's opt_state may pickle optimizer classes; the port's
    loader reads the arrays without importing the modules that define
    them, and prefers EMA parameters."""
    modname = "fake_optimizer_lib_for_test.state"
    mod = types.ModuleType(modname)
    State = namedtuple("ScaleByAdamState", ["count", "mu"])
    State.__module__ = modname
    mod.ScaleByAdamState = State
    sys.modules[modname] = mod
    sys.modules[modname.split(".")[0]] = types.ModuleType(
        modname.split(".")[0])
    params = {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}
    ema = {"w": np.ones((2, 3), np.float32)}
    payload = {"params": params, "ema_params": ema, "batch_stats": {},
               "opt_state": (State(np.int32(3), {"w": np.zeros(3)}),),
               "epoch": 7}
    try:
        ckdir = tmp_path / "ckpt_ep7"
        ckdir.mkdir()
        with open(ckdir / "payload.pkl", "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
        with open(tmp_path / "flat.pkl", "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    finally:
        del sys.modules[modname], sys.modules[modname.split(".")[0]]
    for path in (str(ckdir), str(tmp_path / "flat.pkl")):
        ck = load_checkpoint(path)
        assert modname not in sys.modules
        assert ck["epoch"] == 7
        np.testing.assert_array_equal(extract_params(ck)["w"], ema["w"])
        np.testing.assert_array_equal(
            extract_params(ck, prefer_ema=False)["w"], params["w"])
        stub = ck["opt_state"][0]
        assert type(stub).__name__ == "ScaleByAdamState"
        assert int(stub.args[0]) == 3
    with pytest.raises(ValueError, match="payload.pkl"):
        load_checkpoint(str(tmp_path / "missing"))


# Every mode is ported, for every preset and both editing families, with
# every mesh axis: a 'model' axis without a process group is refused
# before anything starts, as the other axes are; the invocations earlier
# slices refused (the side presets, --family main) reach their own
# argument checks.
_UNPORTED_ARGS = {
    "train": (["--preset", "mnist", "-o", "train.mesh_model=2"],
              "needs 2 processes"),
    "generate": (["--preset", "labml"], "Checkpoint path required"),
    "img2img": (["--family", "main"], "--ckpt and --orig_img required")}


@pytest.mark.parametrize("mode", ["train", "generate", "img2img"])
def test_cli_unported_modes_return_1(mode, capsys):
    from diffusionmodel_tpu_torch.cli import main

    args, said = _UNPORTED_ARGS[mode]
    assert main(["--mode", mode] + args) == 1
    assert said in capsys.readouterr().out


def test_cli_serve_needs_ckpt(capsys):
    from diffusionmodel_tpu_torch.cli import main

    assert main(["--mode", "serve"]) == 1
    assert "Checkpoint path required" in capsys.readouterr().out


def test_library_path_hashes_every_header(tmp_path, monkeypatch):
    """A library's name hashes its source and every ``csrc/*.cuh``, so an
    edited header rebuilds every library, also those that include it."""
    import shutil

    from diffusionmodel_tpu_torch.kernels import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(REPO / "diffusionmodel_tpu_torch" / "kernels" / "csrc",
                    csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {name: _build.library_path(name) for name in _build.SOURCES}
    assert before == {name: _build.library_path(name)
                      for name in _build.SOURCES}
    header = csrc / "tf32_mma.cuh"
    data = bytearray(header.read_bytes())
    data[-2] ^= 1  # one byte of the header's last line
    header.write_bytes(bytes(data))
    after = {name: _build.library_path(name) for name in _build.SOURCES}
    assert all(after[name] != before[name] for name in _build.SOURCES)
    for name in ("flash_attn", "flash_attn_bwd"):
        assert '#include "tf32_mma.cuh"' in (csrc / f"{name}.cu").read_text()


def test_port_sources_exist_for_every_kernel():
    csrc = REPO / "diffusionmodel_tpu_torch" / "kernels" / "csrc"
    from diffusionmodel_tpu_torch.kernels import _build

    for name in _build.SOURCES:
        src = (csrc / f"{name}.cu").read_text()
        assert 'extern "C"' in src and "error_string" in src
        assert "torch/extension.h" not in src
    assert os.path.basename(_build.BUILD_DIR) == "build"
