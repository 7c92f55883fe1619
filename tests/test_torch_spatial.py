"""The port's spatially sharded forward (``parallel.spatial``, ROADMAP
A12b) against the JAX package's spatial mesh and against the port's
one-process runs (CPU, float32).

The port's ranks are spawned gloo processes (``tests/
torch_spatial_ranks.py``, which imports no JAX) in two groups, all
started by one module fixture beside a process of its own for the JAX
side (``tests/jax_spatial_side.py``, which imports no torch: JAX's GSPMD
forwards on its 8 CPU devices and its data x spatial train step):

- 4 ranks: the halo exchange's backward, the forwards at 32 px over 4
  slabs (data 1) and at 64 px over 2 slabs (data 2), the data 2 x
  spatial 2 train step, ``make_sampler(mesh=)`` on both meshes, ``fit``
  with ``mesh_data=2, mesh_spatial=2``;
- 2 ranks: the forward at 64 px over 2 slabs (data 1), then
  ``SamplerService(mesh=)`` fanned out over data 2;
- 3 ranks: ``fit`` with ``mesh_spatial=3`` at 32 px, which 3 does not
  divide (whole images on every process, as the JAX package falls back
  to sharding over 'data').

One-process references run single-threaded, as the ranks do. Bounds:
JAX's for its spatial forward and mesh sampler (rtol 2e-4, atol 1e-5);
where the random tiny net amplifies float32 GroupNorm rounding past them
(64 px: the one-process port lands up to 4.4x the bound from its own
spatial run, and 1.5x from JAX's unsharded forward), the port's spatial
forward is held to them against a one-process run whose GroupNorms take
float64 statistics as the slabs do, and to the whole-net parity bound
of ``tests/test_torch_model.py`` (rtol 5e-3, atol 1e-4) against JAX."""

import contextlib
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

import torch_parallel_ranks as pranks
import torch_spatial_ranks as ranks
from jax_spatial_side import (
    FORWARDS,
    LR,
    STEP_OVER,
    STEP_SEEDS,
    TINY,
    forward_input,
    step_draws,
    wire_batch,
)
from diffusionmodel_tpu_torch.compat.flax_bridge import flax_from_state_dict
from diffusionmodel_tpu_torch.config import preset
from diffusionmodel_tpu_torch.kernels.coord_attn import (
    CoordAttnWeights,
    coord_attn_plain,
    coord_attn_slab_apply,
    coord_attn_slab_mix,
    coord_attn_slab_pool,
)
from diffusionmodel_tpu_torch.kernels.se_block import (
    se_block_plain,
    se_slab_apply,
    se_slab_pool,
)

JAX_RTOL, JAX_ATOL = 2e-4, 1e-5  # the JAX package's spatial bounds
PARITY_RTOL, PARITY_ATOL = 5e-3, 1e-4  # tests/test_torch_model.py
FOUR_RANKS = ("32px_s4_d1", "64px_s2_d2")
SAMPLE_OVER = {**TINY, "diffusion.n_T": 12, "sample.ddim_steps": 4}
SAMPLER_RUNS = [
    ("ddim_d2_s2", preset("full", **SAMPLE_OVER, **{
        "sample.sampler": "ddim", "sample.ddim_eta": 0.5}), 4, (2, 2)),
    ("ancestral_d1_s4", preset("full", **SAMPLE_OVER, **{
        "sample.sampler": "ancestral"}), 2, (1, 4))]
FIT_OVER = {
    "model.n_feat": 8, "model.img_size": 32, "diffusion.n_T": 4,
    "train.batch_size": 4, "train.accum_steps": 2, "train.n_epoch": 1,
    "train.eval_sample_count": 2, "train.eval_every": 1,
    "train.min_save_ep": 100, "train.save_freq": 100}
FIT_CFG = preset("full", **FIT_OVER, **{"train.mesh_data": 2,
                                        "train.mesh_spatial": 2})
# 3 does not divide 32 px: the JAX package shards such a batch over 'data'
# only, and the processes along 'spatial' hold whole images
FIT_S3_CFG = preset("full", **FIT_OVER, **{"train.mesh_data": 1,
                                           "train.mesh_spatial": 3})
SERVICE_CFG = preset("full", **{**TINY, "diffusion.n_T": 12,
                                "sample.ddim_steps": 3})


@contextlib.contextmanager
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _fwd_case(name):
    _, nf, img, spatial, data = next(f for f in FORWARDS if f[0] == name)
    return nf, img, spatial, data


def _start_jax_side(base):
    tests = os.path.dirname(os.path.abspath(__file__))
    code = (f"import sys; sys.path[:0] = [{tests!r}]; import conftest; "
            f"import jax_spatial_side as j; j.main({str(base)!r})")
    return subprocess.Popen([sys.executable, "-c", code], cwd=tests,
                            stdout=subprocess.DEVNULL,
                            stderr=open(base / "jax_side.log", "wb"))


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The JAX side, the 4-rank and the 2-rank groups, all started at the
    first test that asks; yields (base dir, ``get(name)``)."""
    base = tmp_path_factory.mktemp("spatial")
    jax_proc = _start_jax_side(base)
    given = {"forward": {}, "step": None}
    cases = {}
    for name, nf, img, spatial, data in FORWARDS:
        model = ranks.context_unet(nf, img)
        given["forward"][name] = flax_from_state_dict(model.state_dict())[0]
        cases[name] = (nf, img, spatial, data, forward_input(img))
    step_cfg = preset("full", **TINY, **STEP_OVER)
    torch.manual_seed(0)
    step_model = pranks.tiny_model(step_cfg)
    given["step"] = flax_from_state_dict(step_model.state_dict())[0]
    with open(base / "jax_in.tmp", "wb") as f:
        pickle.dump(given, f)
    os.replace(base / "jax_in.tmp", base / "jax_in.pkl")
    draws = [step_draws(jax.random.PRNGKey(s), step_cfg.diffusion)
             for s in STEP_SEEDS]
    batches = [wire_batch(i) for i in range(len(STEP_SEEDS))]
    groups = {
        "four": (pranks.spawn(
            ranks.spatial_ranks, 4, base,
            {k: v for k, v in cases.items() if k in FOUR_RANKS},
            (step_cfg, batches, draws), SAMPLER_RUNS,
            (FIT_CFG, str(base))), 4),
        "two": (pranks.spawn(
            ranks.pair_ranks, 2, base,
            {k: v for k, v in cases.items() if k not in FOUR_RANKS},
            SERVICE_CFG), 2),
        "three": (pranks.spawn(ranks.fit_s3_ranks, 3, base, FIT_S3_CFG,
                               str(base)), 3)}
    done = {}

    def get(name):
        if name == "jax":
            rc = jax_proc.wait(timeout=600)
            assert rc == 0, (base / "jax_side.log").read_text()[-4000:]
            with open(base / "jax_side.pkl", "rb") as f:
                return pickle.load(f)
        if name not in done:
            (ctx, out), world = groups[name]
            done[name] = pranks.join(ctx, out, world)
        return done[name]

    yield base, get
    for name, ((ctx, _), _) in groups.items():
        if name not in done:
            for p in ctx.processes:
                p.kill()
    jax_proc.kill()
    jax_proc.wait()


def _ranks_for(name, get):
    return get("four" if name in FOUR_RANKS else "two")


def _within(got, want, rtol, atol) -> float:
    """The worst element's share of the bound (<= 1 passes)."""
    return float(np.max(np.abs(got - want) / (atol + rtol * np.abs(want))))


# ------------------------------------------------------ no processes
def _slab_inputs(seed=0, b=2, l=16, c=32, r=8):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, l, l, c, generator=g)
    wts = CoordAttnWeights(
        w1h=torch.randn(c + 1, r, generator=g) * 0.2,
        w1w=torch.randn(c + 1, r, generator=g) * 0.2,
        nh=torch.randn(2, r, generator=g), nw=torch.randn(2, r, generator=g),
        wmix=torch.randn(2 * (r + 1), r, generator=g) * 0.2,
        wout=torch.randn(2 * r, c, generator=g) * 0.2,
        bout=torch.randn(2, c, generator=g) * 0.1,
        scal=torch.rand(4, generator=g))
    w1 = torch.randn(c, r, generator=g) * 0.2
    w2 = torch.randn(r, c, generator=g) * 0.2
    return x, wts, w1, w2


@pytest.mark.parametrize("kernel", ["se", "coord_attn"])
@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slab_twins_match_whole_map_twins(kernel, shards, dtype):
    """The slab forms' twins (``se_slab_pool`` / ``se_slab_apply``; the
    CoordAttn pool, bottleneck and apply stages) on each slab, the
    partial statistics combined in process as the collectives combine
    them, against the whole-map twins: float32 within 1e-6 (summation
    order), bf16 within one bf16 ulp of the output."""
    x, wts, w1, w2 = _slab_inputs()
    x = x.to(dtype)
    l = x.shape[1]
    hs = l // shards
    slabs = [t.contiguous() for t in x.split(hs, dim=1)]
    if kernel == "se":
        want = se_block_plain(x, w1, w2)
        sums = sum(se_slab_pool(t) for t in slabs)
        got = torch.cat([se_slab_apply(t, sums, w1, w2, l * l)
                         for t in slabs], dim=1)
    else:
        want = coord_attn_plain(x, wts, "group", 4)
        pools = [coord_attn_slab_pool(t) for t in slabs]
        yn, yx = coord_attn_slab_mix(torch.cat([p[0] for p in pools], 1),
                                     sum(p[1] for p in pools), wts, "group",
                                     4)
        got = torch.cat([coord_attn_slab_apply(t, yn, yx, wts, k * hs)
                         for k, t in enumerate(slabs)], dim=1)
    assert got.dtype == dtype and got.shape == want.shape
    tol = 1e-6 if dtype == torch.float32 else \
        2.0 ** -7 * want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol


# -------------------------------------------------------- the ranks
@pytest.mark.parametrize("conv", ["3x3", "4x4s2"])
def test_halo_exchange_backward_matches_unsharded_conv(started, conv):
    """A 3x3 and a 4x4 stride-2 convolution on four 4-row slabs (halo rows
    from the neighbours, zeros at the edges): the slabs' outputs and input
    gradients (the halo's gradients added back into the owners' rows)
    and the weight gradient summed over the slabs equal autograd of the
    unsharded convolution within 1e-5 (the weight gradient, a sum over
    every position taken in slabs, within 1e-5 relative)."""
    _, get = started
    got = get("four")
    want = ranks.halo_grads()[conv]
    for i, what in enumerate(("output", "input gradient")):
        whole = torch.cat([r["halo"][conv][i] for r in got], dim=2)
        torch.testing.assert_close(whole, want[i], rtol=0, atol=1e-5,
                                   msg=f"{conv} {what}")
    for r in got:
        torch.testing.assert_close(r["halo"][conv][2], want[2], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("name", [f[0] for f in FORWARDS])
def test_spatial_forward_matches_jax_and_one_process(started, name):
    """The port's forward on H-slabs (``image_sharding``: batch over 'data',
    H over 'spatial'; eval mode, with the spatial mask) against JAX's
    GSPMD forward of the same weights (``build_model(spatial_shards=)``)
    and against the port in one process. 32 px over 4 slabs: within JAX's
    bounds of both. 64 px over 2 slabs: within JAX's bounds of the
    one-process port with float64 GroupNorm statistics, and within the
    whole-net parity bound of JAX (module docstring)."""
    _, get = started
    nf, img, spatial, data = _fwd_case(name)
    inputs = forward_input(img)
    got = [r["forward"][name].numpy() for r in _ranks_for(name, get)]
    for g in got[1:]:
        np.testing.assert_array_equal(g, got[0])
    mine = got[0]
    assert mine.shape == (2, img, img, 3) and np.isfinite(mine).all()
    jx = get("jax")["forward"][name]
    with one_thread():
        model = ranks.context_unet(nf, img)
        one = ranks.forward(model, inputs).numpy()
        with ranks.float64_group_norm_stats(model):
            one64 = ranks.forward(model, inputs).numpy()
    if img == 32:
        assert _within(mine, jx, JAX_RTOL, JAX_ATOL) <= 1, name
        assert _within(mine, one, JAX_RTOL, JAX_ATOL) <= 1, name
    else:
        assert _within(mine, one64, JAX_RTOL, JAX_ATOL) <= 1, name
        assert _within(mine, jx, PARITY_RTOL, PARITY_ATOL) <= 1, name
        assert _within(one, jx, PARITY_RTOL, PARITY_ATOL) <= 1, name


def test_data_spatial_train_step_matches_jax(started):
    """Two train steps (A = 2 micro-batches of 4, 32 px) on data 2 x
    spatial 2 ranks, each holding an H-slab of its samples, from the
    weights and draws of JAX's step on its data 2 x spatial 2 mesh with
    ``image_sharding`` batches: the losses within 1e-5 relative, the
    parameters by PR 14's parity distribution against the step size
    (median |port - JAX| <= 1% of lr, 99th percentile <= 5%), and the
    losses within 1e-5 relative of the port's one-process step."""
    _, get = started
    got = get("four")
    jlosses, jparams = get("jax")["step"]
    mine = got[0]["step"]
    for r in got[1:]:
        assert r["step"]["losses"] == mine["losses"]
        assert all(torch.equal(r["step"]["params"][n], p)
                   for n, p in mine["params"].items())
    np.testing.assert_allclose(mine["losses"], jlosses, rtol=1e-5)
    flat = np.concatenate([np.ravel(np.asarray(v)) for v in jax.tree.leaves(
        flax_from_state_dict(mine["params"])[0])])
    want = np.concatenate([np.ravel(np.asarray(v))
                           for v in jax.tree.leaves(jparams)])
    step_cfg = preset("full", **TINY, **STEP_OVER)
    torch.manual_seed(0)
    before = np.concatenate([np.ravel(np.asarray(v)) for v in jax.tree.leaves(
        flax_from_state_dict(pranks.tiny_model(step_cfg).state_dict())[0])])
    off = np.abs(flat - want)
    assert np.median(np.abs(want - before)) > 0.5 * LR
    assert np.median(off) <= 0.01 * LR, np.median(off)
    assert np.percentile(off, 99) <= 0.05 * LR, np.percentile(off, 99)
    with one_thread():
        one = ranks.train_steps(step_cfg, [wire_batch(i) for i in range(2)],
                                [step_draws(jax.random.PRNGKey(s),
                                            step_cfg.diffusion)
                                 for s in STEP_SEEDS])
    np.testing.assert_allclose(mine["losses"], one["losses"], rtol=1e-5)


@pytest.mark.parametrize("name", [n for n, _, _, _ in SAMPLER_RUNS])
def test_spatial_sampler_matches_one_process(started, name):
    """``make_sampler(mesh=)`` in the big-image layout (each process an
    H-slab of its block of the slots; DDIM-4 with eta 0.5 on data 2 x
    spatial 2, ancestral over n_T 12 on spatial 4) against one process,
    within the JAX package's bounds for its spatial mesh sampler (rtol
    2e-4, atol 1e-5); every rank returns the whole batch."""
    _, get = started
    got = get("four")
    cfg, n = next((c, k) for nm, c, k, _ in SAMPLER_RUNS if nm == name)
    with one_thread():
        want = ranks.run_sampler(cfg, n).numpy()
    for r in got:
        imgs = r["samples"][name].numpy()
        assert imgs.shape == want.shape and np.isfinite(imgs).all()
        assert _within(imgs, want, JAX_RTOL, JAX_ATOL) <= 1, name


@pytest.fixture(scope="module")
def one_fit_losses(tmp_path_factory):
    """The epoch's (train, validation) losses of ``FIT_CFG`` in one
    process."""
    save = tmp_path_factory.mktemp("one_fit")
    with one_thread():
        ranks.one_fit(FIT_CFG, save)
    return pranks._metrics_losses(save, 0)


def test_fit_over_data_and_spatial_matches_one_process(started,
                                                       one_fit_losses):
    """``fit`` with ``mesh_data=2, mesh_spatial=2`` (n_feat 8, 32 px, one
    epoch, in-loop sampling on the slabs): only rank 0 writes, and the
    epoch's train loss matches a one-process run within 1e-4 relative
    (the JAX package's ``test_fit_spatial_train_batches_match_plain``
    bound, which reads the train loss); the validation loss, taken with
    the epoch's parameters (which carry the steps' float32 differences
    through the net: 2.6e-4 measured here), within 1e-3."""
    base, get = started
    got = get("four")
    assert not any(r["jax_imported"] for r in got)
    assert (base / "fit_rank0" / "metrics" / "metrics_ep0.json").exists()
    assert list((base / "fit_rank0").glob("img_ep0_w*.png"))
    assert not any((base / f"fit_rank{r}").exists() for r in (1, 2, 3))
    train, val = pranks._metrics_losses(base / "fit_rank0", 0)
    one_train, one_val = one_fit_losses
    np.testing.assert_allclose(train, one_train, rtol=1e-4)
    np.testing.assert_allclose(val, one_val, rtol=1e-3)
    for r in got[1:]:
        assert all(torch.equal(r["fit"][n], p)
                   for n, p in got[0]["fit"].items())


def test_fit_over_spatial_that_does_not_divide_the_image(started,
                                                         one_fit_losses):
    """``fit`` with ``mesh_spatial=3`` at 32 px: 3 does not divide 32, so
    the model keeps whole images on every process (the JAX package's
    ``trainer.py:436`` condition, ``parallel.spatial.runs_on_slabs``) and
    the batch is sharded over 'data' only; the losses match one process
    within the bounds above and the replicas end on the same
    parameters."""
    base, get = started
    got = get("three")
    assert not any(r["jax_imported"] for r in got)
    assert not any((base / f"fit_s3_rank{r}").exists() for r in (1, 2))
    train, val = pranks._metrics_losses(base / "fit_s3_rank0", 0)
    one_train, one_val = one_fit_losses
    np.testing.assert_allclose(train, one_train, rtol=1e-4)
    np.testing.assert_allclose(val, one_val, rtol=1e-3)
    for r in got[1:]:
        assert all(torch.equal(r["fit"][n], p)
                   for n, p in got[0]["fit"].items())


def test_sampler_service_fans_out_over_two_ranks(started):
    """``SamplerService(mesh=)`` over data 2 (max_batch 4, DDIM-3): a pinned
    request alone (slots 0-1, rank 0's block) and batched behind another
    (slots 2-3, rank 1's block) gives the same bits, and the fanned-out
    images are within the JAX bounds of the one-process service's."""
    _, get = started
    got = get("two")
    assert not any(r["jax_imported"] for r in got)
    assert got[1]["service"] is None  # the follower ran to rank 0's stop
    fanned = got[0]["service"]
    np.testing.assert_array_equal(fanned["alone"], fanned["batched"])
    assert fanned["stats"]["batches"] == 2
    with one_thread():
        one = ranks.service_requests(SERVICE_CFG)
    np.testing.assert_array_equal(one["alone"], one["batched"])
    for key in ("alone", "other", "batched"):
        assert _within(fanned[key], one[key], JAX_RTOL, JAX_ATOL) <= 1, key
