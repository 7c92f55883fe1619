"""The port's quality metrics against the JAX package on the CPU.

- SSIM, PSNR, the Frechet distance, polynomial MMD^2 and KID: the same
  float64 / float32 numpy arithmetic, so bit-equal.
- The InceptionV3 trunk: the port's weights (the proxy's draws with
  BatchNorm statistics moved away from identity) carried to flax by the JAX
  package's own ``convert_torchvision_inception``; each top-level block's
  output at 75 px (the smallest input the trunk takes) and the pooled
  features at 75 and 299 px within atol 5e-4 / rtol 5e-3
  (``tests/test_inception_parity.py``'s whole-trunk tolerance: the same
  fp32 network summed in another order by two frameworks).
- ``extract_features``: the JAX proxy's own variables handed to the port
  by ``inception_state_dict_from_flax``; 32, 256 and 320 px inputs (the
  last one shrinks, with antialiasing) and a one-channel input, same
  tolerance. The JAX trunk is jitted once per input shape for the module.
- ``evaluate_batch``, ``evaluate_folders`` and ``--mode eval``: one numpy
  feature function given to both packages; results equal to rtol 1e-6
  (the two resizes to 299 differ by ~1e-7).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusionmodel_tpu.metrics import folder_eval as jfolder
from diffusionmodel_tpu.metrics import image_metrics as jim
from diffusionmodel_tpu.metrics.inception import (
    InceptionV3Features as JInception,
    convert_torchvision_inception,
)
from diffusionmodel_tpu_torch.compat.flax_bridge import (
    inception_state_dict_from_flax,
)
from diffusionmodel_tpu_torch.metrics import folder_eval as tfolder
from diffusionmodel_tpu_torch.metrics import image_metrics as tim
from diffusionmodel_tpu_torch.metrics import inception as tinc

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

torch.set_num_threads(2)

ATOL, RTOL = 5e-4, 5e-3
BLOCKS = ("Conv2d_4a_3x3", "Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
          "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e", "Mixed_7a",
          "Mixed_7b", "Mixed_7c")


# ------------------------------------------------------------ numpy parts
def test_numpy_metrics_bit_equal():
    rng = np.random.RandomState(0)
    a = rng.uniform(-1, 1, (3, 16, 16)).astype(np.float32)  # renormalized
    b = rng.uniform(0, 1, (16, 16, 3)).astype(np.float32)
    c = rng.uniform(0, 1, (16, 16, 3)).astype(np.float32)
    for x, y in ((a, a * 0.9), (b, c), (b, b)):
        assert tim.calc_ssim(x, y) == jim.calc_ssim(x, y)
        assert tim.calc_psnr(x, y) == jim.calc_psnr(x, y)
    assert tim.calc_psnr(b, b) == float("inf") == jim.calc_psnr(b, b)
    np.testing.assert_array_equal(tim._to_unit_range(a),
                                  jim._to_unit_range(a))
    f1, f2 = rng.randn(40, 12), rng.randn(30, 12) * 1.3 + 0.2
    mu1, mu2 = f1.mean(0), f2.mean(0)
    s1, s2 = np.cov(f1, rowvar=False), np.cov(f2, rowvar=False)
    np.testing.assert_array_equal(tim.matrix_sqrt_psd(s1),
                                  jim.matrix_sqrt_psd(s1))
    assert tim.frechet_distance(mu1, s1, mu2, s2) == \
        jim.frechet_distance(mu1, s1, mu2, s2)
    assert tim.polynomial_mmd2(f1, f2) == jim.polynomial_mmd2(f1, f2)
    assert tim.polynomial_mmd2(f1, f2, degree=2, gamma=0.5, coef0=0.0) == \
        jim.polynomial_mmd2(f1, f2, degree=2, gamma=0.5, coef0=0.0)
    assert tim.kid_from_feats(f1, f2, n_subsets=7, subset_size=20, seed=3) \
        == jim.kid_from_feats(f1, f2, n_subsets=7, subset_size=20, seed=3)


# ---------------------------------------------------------- the trunk
def _port_trunk(seed=7):
    """The proxy's conv draws with BatchNorm scale, bias and statistics
    away from identity, so a mix-up of the four cannot cancel out."""
    model = tinc.proxy_inception(seed=seed, device="cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.copy_(0.5 + torch.rand(m.weight.shape, generator=g))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
                m.running_mean.copy_(0.05 * torch.randn(
                    m.running_mean.shape, generator=g))
                m.running_var.copy_(0.8 + 0.4 * torch.rand(
                    m.running_var.shape, generator=g))
    return model


def _flax_vars(model):
    params, stats = convert_torchvision_inception(
        {k: v.numpy() for k, v in model.state_dict().items()})
    return {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def jtrunk():
    """The JAX trunk's apply, jitted once for the module (one compile per
    input shape)."""
    return jax.jit(JInception().apply)


@pytest.fixture(scope="module")
def jax_proxy_vars():
    """The JAX proxy's variables, as ``_default_feature_fn`` builds them
    (jax.random.PRNGKey(42), flax init, x sqrt 2 on the conv kernels)."""
    fn = jim._default_feature_fn()
    cells = dict(zip(fn.__code__.co_freevars,
                     (c.cell_contents for c in fn.__closure__)))
    return cells["variables"]


def test_bridge_round_trip_bit_exact():
    model = _port_trunk()
    v = _flax_vars(model)
    back = inception_state_dict_from_flax(v["params"], v["batch_stats"])
    sd = model.state_dict()
    assert set(back) == set(sd)
    for k, t in sd.items():
        torch.testing.assert_close(back[k], t, rtol=0, atol=0, msg=k)


def test_trunk_blocks_match_flax_at_75px():
    model = _port_trunk()
    x = np.random.RandomState(1).rand(2, 75, 75, 3).astype(np.float32)
    got = {}
    hooks = [getattr(model, n).register_forward_hook(
        lambda m, a, out, n=n: got.__setitem__(n, out.permute(0, 2, 3, 1)))
        for n in BLOCKS]
    with torch.no_grad():
        feats = model(torch.from_numpy(x)).numpy()
    for h in hooks:
        h.remove()
    want, inter = JInception().apply(
        _flax_vars(model), jnp.asarray(x), capture_intermediates=lambda m, n:
        n == "__call__" and len(m.scope.path) == 1, mutable=["intermediates"])
    for n in BLOCKS:
        np.testing.assert_allclose(
            got[n].numpy(), np.asarray(inter["intermediates"][n]
                                       ["__call__"][0]),
            atol=ATOL, rtol=RTOL, err_msg=n)
    np.testing.assert_allclose(feats, np.asarray(want), atol=ATOL, rtol=RTOL)


def test_trunk_matches_flax_at_299px(jtrunk):
    model = _port_trunk(seed=8)
    x = np.random.RandomState(2).rand(2, 299, 299, 3).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = np.asarray(jtrunk(_flax_vars(model), jnp.asarray(x)))
    assert got.shape == (2, 2048)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("size, ch", [(32, 3), (256, 3), (320, 3), (48, 1)])
def test_extract_features_matches_jax_proxy(size, ch, jtrunk,
                                            jax_proxy_vars):
    """The port's ``ImageMetrics`` on the JAX proxy's weights (through the
    bridge) against the JAX ``ImageMetrics``: [-1, 1] inputs renormalized,
    one channel tiled, resized to 299 (bilinear, antialiased when a side
    shrinks)."""
    imgs = np.random.RandomState(size).uniform(
        -1, 1, (2, size, size, ch)).astype(np.float32)
    want = jim.ImageMetrics(feature_fn=lambda b: jtrunk(
        jax_proxy_vars, b)).extract_features(imgs)
    model = tinc.InceptionV3Features().eval()
    model.load_state_dict(inception_state_dict_from_flax(
        jax_proxy_vars["params"], jax_proxy_vars["batch_stats"]))
    got = tim.ImageMetrics(feature_fn=lambda b: model(b).detach(),
                           device="cpu").extract_features(imgs)
    assert got.shape == (2, 2048)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_resize_shrinks_like_jax():
    """512 px -> 299: ``F.interpolate`` without antialiasing is off by up
    to 0.54 from ``jax.image.resize``; the port's resize is not."""
    x = np.random.RandomState(5).rand(1, 512, 512, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 299, 299, 3),
                                       "bilinear"))
    got = tim.resize_to_299(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# ----------------------------------------------- dispatcher and folders
_PROJ = np.random.RandomState(9).randn(299 * 299 * 3, 8) / 300.0


def _shared_fn(x):
    """One numpy feature function for both packages: a fixed random
    projection of the 299 px batch to 8 features."""
    x = np.asarray(x, np.float64)
    return x.reshape(len(x), -1) @ _PROJ


def _pair(a, b, key):
    """rtol 1e-6; a KID standard deviation against its mean (with 12
    images per side every subset holds them all, so the deviation is
    rounding)."""
    atol = 1e-6 * abs(b[key.replace("_std", "")]) if key.endswith(
        "_std") else 0.0
    np.testing.assert_allclose(a[key], b[key], rtol=1e-6, atol=atol,
                               err_msg=key)


def test_evaluate_batch_matches_jax():
    rng = np.random.RandomState(4)
    real = rng.uniform(-1, 1, (12, 32, 32, 3)).astype(np.float32)
    gen = (0.7 * real + 0.2 * rng.randn(12, 32, 32, 3)).astype(np.float32)
    want = jim.ImageMetrics(feature_fn=_shared_fn).evaluate_batch(real, gen)
    got = tim.ImageMetrics(feature_fn=_shared_fn,
                           device="cpu").evaluate_batch(real, gen)
    assert set(got) == set(want) == {"fid", "ssim", "psnr"}
    assert got["ssim"] == want["ssim"] and got["psnr"] == want["psnr"]
    _pair(got, want, "fid")
    # fewer than 10 per side: no FID; unequal counts: no SSIM / PSNR
    few = tim.ImageMetrics(feature_fn=_shared_fn, device="cpu")
    assert set(few.evaluate_batch(real[:4], gen[:4])) == {"ssim", "psnr"}
    assert few.evaluate_batch(real, gen[:11]) == \
        {"fid": pytest.approx(jim.ImageMetrics(
            feature_fn=_shared_fn).evaluate_batch(real, gen[:11])["fid"],
            rel=1e-6)}


def _write_folders(root, by_class):
    rng = np.random.RandomState(11)
    for side, base in (("real", 0.3), ("gen", 0.5)):
        for cls in (("a", "b") if by_class[side] else ("",)):
            d = root / side / cls
            d.mkdir(parents=True, exist_ok=True)
            for i in range(6 if by_class[side] else 12):
                arr = (rng.rand(40, 40, 3) * 0.4 + base) * 255
                Image.fromarray(arr.astype(np.uint8)).save(d / f"{i}.png")


@pytest.mark.parametrize("layout", ["classes", "flat", "mixed"])
def test_evaluate_folders_matches_jax(layout, tmp_path):
    by_class = {"classes": {"real": True, "gen": True},
                "flat": {"real": False, "gen": False},
                "mixed": {"real": True, "gen": False}}[layout]
    _write_folders(tmp_path, by_class)
    args = (str(tmp_path / "real"), str(tmp_path / "gen"))
    want = jfolder.evaluate_folders(
        *args, metrics=jim.ImageMetrics(feature_fn=_shared_fn), img_size=32)
    got = tfolder.evaluate_folders(
        *args, metrics=tim.ImageMetrics(feature_fn=_shared_fn, device="cpu"),
        img_size=32)
    assert set(got) == set(want)
    for k in ("n_real", "n_gen", "n_pairs", "ssim", "psnr"):
        assert got[k] == want[k], k
    for k in ("fid", "kid_x1000", "kid_x1000_std"):
        _pair(got, want, k)


def test_cli_eval_matches_jax_cli(tmp_path, monkeypatch, capsys):
    """``--mode eval`` of both CLIs on the same folders, both proxies
    replaced by the shared numpy feature function."""
    from diffusionmodel_tpu.cli import main as jmain
    from diffusionmodel_tpu_torch.cli import main as tmain

    monkeypatch.setattr(jim, "_default_feature_fn", lambda: _shared_fn)
    monkeypatch.setattr(tinc, "proxy_inception",
                        lambda device=None: _shared_fn)
    _write_folders(tmp_path, {"real": True, "gen": True})
    common = ["--mode", "eval", "--real_dir", str(tmp_path / "real"),
              "--gen_dir", str(tmp_path / "gen"), "--img_size", "32"]
    assert jmain(common + ["--eval_out", str(tmp_path / "j.json")]) == 0
    assert tmain(common + ["--eval_out", str(tmp_path / "t" / "t.json"),
                           "--device", "cpu"]) == 0
    want = json.loads((tmp_path / "j.json").read_text())
    got = json.loads((tmp_path / "t" / "t.json").read_text())
    assert set(got) == set(want) >= {"fid_proxy", "kid_proxy_x1000", "ssim",
                                     "psnr", "n_pairs"}
    for k in ("n_real", "n_gen", "n_pairs", "ssim", "psnr"):
        assert got[k] == want[k], k
    for k in ("fid_proxy", "kid_proxy_x1000", "kid_proxy_x1000_std"):
        _pair(got, want, k)
    assert "Wrote" in capsys.readouterr().out
    assert tmain(["--mode", "eval", "--device", "cpu"]) == 1
    assert "--real_dir and --gen_dir required" in capsys.readouterr().out


# ------------------------------------------------------- weights files
def test_inception_weights_files_load(tmp_path, capsys):
    """An ``.npz`` and a ``.pt`` state dict load into the trunk (fc and
    AuxLogits entries dropped, ``num_batches_tracked`` optional); a file
    that is not one, or a missing file through the CLI, is a clear
    error."""
    from diffusionmodel_tpu_torch import cli

    sd = _port_trunk(seed=3).state_dict()
    arrays = {k: v.numpy() for k, v in sd.items()
              if not k.endswith("num_batches_tracked")}
    arrays["fc.weight"] = np.zeros((2, 2048), np.float32)
    np.savez(tmp_path / "w.npz", **arrays)
    torch.save(dict(sd, **{"AuxLogits.fc.bias": torch.zeros(3)}),
               tmp_path / "w.pt")
    for name in ("w.npz", "w.pt"):
        m = tinc.load_inception(str(tmp_path / name), "cpu")
        for k, v in m.state_dict().items():
            if not k.endswith("num_batches_tracked"):
                torch.testing.assert_close(v, sd[k], rtol=0, atol=0, msg=k)
    np.savez(tmp_path / "bad.npz", x=np.zeros(3))
    with pytest.raises(ValueError, match="not an inception_v3 state dict"):
        tinc.load_inception(str(tmp_path / "bad.npz"), "cpu")
    with pytest.raises(FileNotFoundError, match="inception_weights"):
        cli.main(["--mode", "eval", "--real_dir", str(tmp_path),
                  "--gen_dir", str(tmp_path), "--device", "cpu",
                  "--inception_weights", str(tmp_path / "missing.npz")])
    im = cli._metrics(cli.build_parser().parse_args(
        ["--inception_weights", str(tmp_path / "w.npz"), "--device", "cpu"]))
    assert im.feature_kind == "inception" and im.fid_key == "fid"
    assert im.device == torch.device("cpu")


def test_image_metrics_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tim.ImageMetrics()
    with pytest.raises(RuntimeError, match="CUDA"):
        tfolder.evaluate_folders(".", ".")
