"""The port's 'model' axis (``parallel.tensor``: output-channel tensor
parallelism) against the JAX package's mesh step and against the port's
one-process runs (CPU).

The port's ranks are spawned gloo processes (``tests/torch_model_ranks.py``,
which imports no JAX) in two groups, started by one module fixture beside
a process of its own for the JAX side (``tests/jax_model_side.py``, which
imports no torch: JAX's jitted step on a data 2 x model 2 mesh with
``param_shardings`` at ``min_channels`` 64, for the replicated and the
ZeRO-1 moment layouts):

- 4 ranks, data 2 x model 2: every layer kind that holds a block (fp32 and
  bf16, forward and VJP) against the same layer whole, the two train
  steps, ``make_sampler`` and ``SamplerService(mesh=)``;
- 8 ranks, data 2 x model 2 x spatial 2: ``fit`` at n_feat 32 (where the
  default 256-channel rule cuts down4, ca4, up0 and the embeddings) with
  ZeRO-1 and in-loop sampling, then a resume of its checkpoint.

One-process references run single-threaded, as the ranks do."""

import contextlib
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

import torch_model_ranks as ranks
import torch_parallel_ranks as pranks
from diffusionmodel_tpu import checkpoint as jckpt
from jax_model_side import MIN_CHANNELS
from jax_parallel_side import LR, STEP_OVER, STEP_SEEDS, TINY, wire_batch
from diffusionmodel_tpu_torch.checkpoint import (
    extract_params,
    load_checkpoint,
    save_checkpoint,
)
from diffusionmodel_tpu_torch.compat.flax_bridge import (
    flax_from_state_dict,
    state_dict_from_flax,
)
from diffusionmodel_tpu_torch.config import preset

JAX_RTOL, JAX_ATOL = 2e-4, 1e-5  # the JAX package's mesh sampler bounds
BLOCK_FACTOR = 0.25  # tests/test_torch_bf16.py: a bf16 block within 0.25 g
BF16_GRAD_FACTOR = 1.5  # bf16 gradients: partial sums rounded per rank
SAMPLE_OVER = {**TINY, "diffusion.n_T": 12, "sample.ddim_steps": 4}
# (name, cfg, slots): 4 slots split over 'data'; 3 do not, so each data
# pair samples all 3 and only the 'model' axis splits the work
SAMPLER_RUNS = [
    ("ddim", preset("full", **SAMPLE_OVER, **{"sample.sampler": "ddim",
                                              "sample.ddim_eta": 0.5}), 4),
    ("ancestral", preset("full", **SAMPLE_OVER,
                         **{"sample.sampler": "ancestral"}), 3)]
SERVICE_CFG = preset("full", **{**TINY, "diffusion.n_T": 12,
                                "sample.ddim_steps": 3})
# gen_samples: 2 per class of 3 (6 slots, split over 'data'), DDIM-3
GEN_OVER = {**TINY, "diffusion.n_T": 12, "sample.sampler": "ddim",
            "sample.ddim_steps": 3, "data_root": "/nonexistent"}
FIT_OVER = {"model.n_feat": 32, "model.img_size": 32, "diffusion.n_T": 4,
            "model.use_pallas": True,
            "train.batch_size": 2, "train.accum_steps": 2,
            "train.n_epoch": 1, "train.zero1": True,
            "train.eval_sample_count": 2, "train.eval_every": 1,
            "train.min_save_ep": 0, "train.save_freq": 1}
MESH_222 = {"train.mesh_data": 2, "train.mesh_model": 2,
            "train.mesh_spatial": 2}
FIT_CFG = preset("full", **FIT_OVER, **MESH_222)
RESUME_CFG = preset("full", **{**FIT_OVER, **MESH_222, "train.n_epoch": 2,
                               "train.min_save_ep": 100,
                               "train.save_freq": 100})


@contextlib.contextmanager
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _step_draws(key, dc):
    """The draws the JAX train step takes from its key for the global
    batch, per micro-batch (as ``tests/test_torch_parallel.py``)."""
    a, b = STEP_OVER["train.accum_steps"], STEP_OVER["train.batch_size"]
    out = []
    for _ in range(a):
        key, sub = jax.random.split(key)
        lkey, _ = jax.random.split(sub)
        tkey, nkey, mkey = jax.random.split(lkey, 3)
        out.append(dict(
            ts=np.array(jax.random.randint(tkey, (b,), 1, dc.n_T + 1)),
            noise=np.array(jax.random.normal(nkey, (b, 32, 32, 3))),
            ctx_mask=np.array(jax.random.bernoulli(
                mkey, 1.0 - dc.drop_prob, (b,)).astype(np.float32))))
    return out


def _step_cfgs():
    cfg = preset("full", **TINY, **STEP_OVER)
    return {"rep": cfg, "zero1": preset("full", **TINY, **STEP_OVER,
                                        **{"train.zero1": True})}


def _start_jax_side(base):
    tests = os.path.dirname(os.path.abspath(__file__))
    code = (f"import sys; sys.path[:0] = [{tests!r}]; import conftest; "
            f"import jax_model_side as j; j.main({str(base)!r})")
    return subprocess.Popen([sys.executable, "-c", code], cwd=tests,
                            stdout=subprocess.DEVNULL,
                            stderr=open(base / "jax_side.log", "wb"))


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The JAX side, the 4-rank and the 8-rank groups, all started at the
    first test that asks; yields (base dir, the tiny net's initial flax
    params, ``get(name)``)."""
    base = tmp_path_factory.mktemp("model_axis")
    jax_proc = _start_jax_side(base)
    cfgs = _step_cfgs()
    params = flax_from_state_dict(
        pranks.tiny_model(cfgs["rep"]).state_dict())[0]
    with open(base / "jax_in.tmp", "wb") as f:
        pickle.dump(params, f)
    os.replace(base / "jax_in.tmp", base / "jax_in.pkl")
    draws = [_step_draws(jax.random.PRNGKey(s), cfgs["rep"].diffusion)
             for s in STEP_SEEDS]
    ckpt = save_checkpoint(str(base / "tiny_ckpt"), {
        "epoch": 0, "params": params, "batch_stats": {}})
    gen_cfg = preset("full", **GEN_OVER, **{"train.mesh_model": 2})
    groups = {
        "four": (pranks.spawn(
            ranks.four_ranks, 4, base, cfgs, [wire_batch(0), wire_batch(1)],
            draws, MIN_CHANNELS, SAMPLER_RUNS, SERVICE_CFG,
            (gen_cfg, ckpt, str(base))), 4),
        "eight": (pranks.spawn(ranks.fit_ranks, 8, base, FIT_CFG,
                               RESUME_CFG, str(base)), 8)}
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

    yield base, params, get, ckpt
    for name, ((ctx, _), _) in groups.items():
        if name not in done:
            for p in ctx.processes:
                p.kill()
    jax_proc.kill()
    jax_proc.wait()


def _flat(tree):
    return np.concatenate([np.ravel(np.asarray(v))
                           for v in jax.tree.leaves(tree)])


def _port_flat(sd):
    return _flat(flax_from_state_dict(sd)[0])


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("kind", ranks.LAYER_KINDS)
def test_layer_on_two_model_ranks_matches_the_whole_layer(started, kind):
    """Each layer kind that holds a block of its output channels (3x3 and
    4x4 stride-2 convolutions, the transposed convolution, the dense
    layer, the fused upsample head, SE and CoordAttn through their
    kernels' twins in eval mode and their plain twins in training) on two
    'model' ranks against the same layer whole: the output, the inputs'
    gradients and the parameters' gradients (each rank's blocks) within
    1e-6 relative in fp32. In bf16 the output within a quarter of the
    whole layer's own bf16-vs-fp32 gap g (``tests/test_torch_bf16.py``'s
    block bound; every kind is bit-exact here), and the gradients within
    1.5 g: a rank's share of the input gradient is rounded to bf16 before
    the sum over 'model' (as GSPMD reduces bf16 partial products), one
    rounding more than the whole layer's, and the chained kinds carry it
    into their upstream layers' weight gradients (0.4-1.1 g measured)."""
    get = started[2]
    got = get("four")
    assert not any(r["jax_imported"] for r in got)
    for r in got:
        f32 = r["layers"][(kind, "float32")]
        bf16 = r["layers"][(kind, "bfloat16")]
        assert f32["cut"] > 0 and f32["cut"] == bf16["cut"], kind
        for err in (f32, bf16):
            assert err["same_leaves"], kind
        for what in ("out", "x_grad", "w_grad"):
            assert f32[what] <= 1e-6, (kind, what, f32[what])
            bound = BLOCK_FACTOR if what == "out" else BF16_GRAD_FACTOR
            assert bf16[what] <= bound * bf16["gap"][what], (
                kind, what, bf16[what], bf16["gap"][what])


def test_coord_attn_pack_follows_the_blocks(started):
    """An eval-mode CoordAttn cut over 'model' keeps its packed (gathered)
    weights between calls without gradients; an in-place update of a
    block, as a step makes, packs them again: the output moves and
    equals a fresh pack's bit for bit on every rank."""
    got = started[2]("four")
    for r in got:
        assert r["pack"] == {"equal_fresh": True, "moved": True}


def test_a_layer_that_cannot_hold_a_block_is_refused(started):
    """A planned weight of a layer without the port's block forward
    (PyTorch's own ``Conv2d``) is refused by name, not run whole."""
    for r in started[2]("four"):
        assert "0.weight (Conv2d) cannot hold a block" in r["refused"]


@pytest.mark.parametrize("layout", ["rep", "zero1"])
def test_data_model_train_step_matches_jax(started, layout):
    """Two train steps (A = 2 micro-batches of 4, n_feat 16, one sample
    per data rank and micro-batch) on data 2 x model 2 ranks, the wide
    leaves cut at 64 channels, from the weights and draws of JAX's step
    on its data 2 x model 2 mesh in the same layout (moments replicated,
    or partitioned over 'data' with ``train.zero1``): the losses within
    1e-5 relative, the parameters and the EMA by the parity
    distribution of ``tests/test_torch_parallel.py`` (median |port -
    JAX| <= 1% of lr, 99th percentile <= 5%); every rank the same whole parameters, each planned leaf held as
    half its rows, the moments the blocks' (a further half of a leaf
    ZeRO-1 partitions), and rank 0's gathered moments whole."""
    _, params, get, _ = started
    got = get("four")
    jlosses, jparams, jema = get("jax")["step"][layout]
    mine = got[0]["steps"][layout]
    assert mine["planned"] > 10
    for r in got:
        run = r["steps"][layout]
        assert run["halves"] and run["moments"], layout
        assert run["losses"] == mine["losses"]
        for key in ("params", "ema"):
            assert all(torch.equal(run[key][n], p)
                       for n, p in mine[key].items()), key
    # the pairs along 'model' hold complementary blocks
    assert {r["model_rank"] for r in got} == {0, 1}
    whole = sum(p.numel() for p in mine["params"].values())
    assert mine["held_numel"] < 0.75 * whole
    assert all(r["steps"][layout]["opt_host"] is None for r in got[1:])
    host = mine["opt_host"]
    assert all(host["mu"][n].shape == tuple(p.shape)
               for n, p in mine["params"].items())
    np.testing.assert_allclose(mine["losses"], jlosses, rtol=1e-5)
    before = _flat(params)
    for key, want in (("params", jparams), ("ema", jema)):
        flat = _port_flat(mine[key])
        want = _flat(want)
        off = np.abs(flat - want)
        if key == "params":
            assert np.median(np.abs(want - before)) > 0.5 * LR
        assert np.median(off) <= 0.01 * LR, (key, np.median(off))
        assert np.percentile(off, 99) <= 0.05 * LR, (
            key, np.percentile(off, 99))


@pytest.mark.parametrize("name", [n for n, _, _ in SAMPLER_RUNS])
def test_sampler_over_model_matches_one_process(started, name):
    """``make_sampler(mesh=)`` on data 2 x model 2, the model cut by the
    sampler (DDIM-4 with eta 0.5 over 4 slots split over 'data';
    ancestral over n_T 12 with 3 slots, which 'data' does not split)
    against one process: relative L2 within 1e-5, every rank the same
    images."""
    get = started[2]
    got = get("four")
    cfg, n = next((c, k) for nm, c, k in SAMPLER_RUNS if nm == name)
    with one_thread():
        want = ranks.run_sampler(cfg, n).numpy()
    for r in got:
        imgs = r["samples"][name].numpy()
        assert imgs.shape == want.shape and np.isfinite(imgs).all()
        np.testing.assert_array_equal(imgs, got[0]["samples"][name].numpy())
    assert _rel(got[0]["samples"][name].numpy(), want) <= 1e-5, name


def test_sampler_service_over_model(started):
    """``SamplerService(mesh=)`` on data 2 x model 2 (max_batch 4, DDIM-3):
    a pinned request alone and batched behind another give the same bits,
    and the images are within the JAX package's mesh bounds of the
    one-process service's."""
    get = started[2]
    got = get("four")
    assert all(r["service"] is None for r in got[1:])
    fanned = got[0]["service"]
    np.testing.assert_array_equal(fanned["alone"], fanned["batched"])
    with one_thread():
        one = ranks.service_requests(SERVICE_CFG)
    for key in ("alone", "other", "batched"):
        np.testing.assert_allclose(fanned[key], one[key], rtol=JAX_RTOL,
                                   atol=JAX_ATOL, err_msg=key)


def test_gen_samples_over_model_matches_one_process(started, tmp_path):
    """``gen_samples`` with ``train.mesh_model=2`` on data 2 x model 2
    (the loaded model cut by ``make_sampler``, 6 slots split over
    'data', DDIM-3) against one process: relative L2 within 1e-5, every
    rank the same images, only rank 0 writes."""
    base, _, get, ckpt = started
    got = get("four")
    with one_thread():
        want = ranks.generate(preset("full", **GEN_OVER), ckpt, tmp_path)
    for r in got:
        np.testing.assert_array_equal(r["generate"], got[0]["generate"])
    assert got[0]["generate"].shape == want.shape == (6, 32, 32, 3)
    assert _rel(got[0]["generate"], want) <= 1e-5
    assert list((base / "gen_rank0").glob("*/samples_g2.0.png"))
    assert not any((base / f"gen_rank{r}").exists() for r in (1, 2, 3))


@pytest.fixture(scope="module")
def one_fit(tmp_path_factory, started):
    """The one-process ``fit`` of ``FIT_CFG`` and its resume for one more
    epoch: (epoch-0 losses, the parameters, the resumed epoch's losses,
    the resumed parameters)."""
    base, _, get, _ = started
    save = tmp_path_factory.mktemp("one_fit")
    with one_thread():
        params = ranks.one_fit(FIT_CFG, save)
        get("eight")  # the ranks' checkpoint is written
        resumed = ranks.one_fit(RESUME_CFG, save / "resume",
                                resume=str(base / "fit_rank0" / "ckpt_ep0"))
    return (pranks._metrics_losses(save, 0), params,
            pranks._metrics_losses(save / "resume", 1), resumed)


def test_fit_on_data_model_spatial_mesh(started, one_fit):
    """``fit`` on a data 2 x model 2 x spatial 2 mesh (8 ranks, n_feat 32,
    ZeRO-1, ``use_pallas``: validation and in-loop sampling through the
    kernels' slab forms' twins on gathered weights): only rank 0 writes; each rank
    holds blocks of the leaves the 256-channel rule plans (down4, ca4,
    up0, the embeddings); the epoch's train loss within 1e-4 relative of
    one process (the bound the JAX package's own mesh ``fit`` test reads)
    and the validation loss within 1e-3 (as the spatial ``fit`` test); the
    checkpoint, whole, loads in the JAX package's ``checkpoint`` module
    and in one process equal to the ranks' gathered parameters; a resume
    of it on the same mesh continues: its epoch's losses within the same
    bounds of one process resuming the same file."""
    base, _, get, _ = started
    got = get("eight")
    assert not any(r["jax_imported"] for r in got)
    assert not any((base / f"fit_rank{r}").exists() for r in range(1, 8))
    assert list((base / "fit_rank0").glob("img_ep0_w*.png"))
    assert all(r["cut"] >= 10 for r in got)
    for r in got[1:]:
        for key in ("params", "resumed"):
            assert all(torch.equal(r[key][n], p)
                       for n, p in got[0][key].items()), key
    one_losses, _, one_resumed_losses, _ = one_fit
    (train, val), (one_train, one_val) = got[0]["losses"], one_losses
    np.testing.assert_allclose(train, one_train, rtol=1e-4)
    np.testing.assert_allclose(val, one_val, rtol=1e-3)
    rtrain, rval = got[0]["resumed_losses"]
    np.testing.assert_allclose(rtrain, one_resumed_losses[0], rtol=1e-4)
    np.testing.assert_allclose(rval, one_resumed_losses[1], rtol=1e-3)

    path = str(base / "fit_rank0" / "ckpt_ep0")
    jck = jckpt.load_checkpoint(path)
    ck = load_checkpoint(path)
    assert jck["epoch"] == ck["epoch"] == 0
    for a, b in zip(jax.tree.leaves(jckpt.extract_params(jck,
                                                         prefer_ema=False)),
                    jax.tree.leaves(extract_params(ck, prefer_ema=False))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    sd = state_dict_from_flax(extract_params(ck, prefer_ema=False))
    for n, p in got[0]["params"].items():
        torch.testing.assert_close(sd[n], p, rtol=0, atol=0, msg=n)
    opt = ck["opt_state"]
    assert all(opt["mu"][n].shape == tuple(p.shape)
               for n, p in got[0]["params"].items())
