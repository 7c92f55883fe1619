"""The port's data parallelism (``diffusionmodel_tpu_torch.parallel``)
against the JAX package's mesh and against the port's one-process runs
(CPU, float32).

JAX runs here on its 8 virtual CPU devices. The port's ranks are spawned
gloo processes (``tests/torch_parallel_ranks.py``, which imports no JAX),
in three groups: 4 ranks for the spatial helpers and the train step, 2
for BatchNorm and the samplers, 2 for ``fit``. All three run while this
process's JAX side traces JAX's mesh step once and compiles it for the
replicated and the ZeRO-1 layout, in a process of its own (about 30 s,
the file's largest cost). The port's one-process references run
single-threaded, as the ranks do: with 8 threads PyTorch's CPU backward
of the tiny net lands 8e-4 (relative L2) from the same gradient summed
per sample at one thread, which would hide what is compared here
(1e-5)."""

import contextlib
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parallel_ranks as ranks
from diffusionmodel_tpu.parallel import make_mesh as jmake_mesh
from diffusionmodel_tpu.parallel import opt_state_shardings as jopt_shardings
from diffusionmodel_tpu.parallel import param_shardings as jparam_shardings
from jax_parallel_side import (
    A,
    B,
    LR,
    RANKS,
    STEP_OVER,
    STEP_SEEDS,
    TINY,
    spatial_input,
    wire_batch,
)
from diffusionmodel_tpu_torch.compat.flax_bridge import flax_from_state_dict
from diffusionmodel_tpu_torch.config import preset
from diffusionmodel_tpu_torch.nn import build_model
from diffusionmodel_tpu_torch.parallel import (
    Mesh,
    opt_state_shardings,
    param_shardings,
)

# BatchNorm and the samplers, 2 ranks
BN_CFG = preset("full", **TINY, **{"model.norm": "batch"})
SAMPLE_TINY = {**TINY, "diffusion.n_T": 12, "sample.ddim_steps": 4,
               "sample.dpm_steps": 4}
SAMPLER_RUNS = [
    ("ancestral", preset("full", **SAMPLE_TINY,
                         **{"sample.sampler": "ancestral"}), 8),
    ("ddim", preset("full", **SAMPLE_TINY, **{"sample.sampler": "ddim",
                                              "sample.ddim_eta": 0.5}), 8),
    ("dpmpp", preset("full", **SAMPLE_TINY,
                     **{"sample.sampler": "dpmpp"}), 8),
    ("uneven", preset("full", **SAMPLE_TINY,
                      **{"sample.sampler": "ddim"}), 7),
    ("textbook", preset("labml", **{"model.n_feat": 8, "model.img_size": 16,
                                    "diffusion.n_T": 4}), 4)]
# fit, 2 ranks (the JAX package's test_fit_zero1_end_to_end, at 2)
FIT_OVER = {"model.n_feat": 8, "model.img_size": 32, "diffusion.n_T": 4,
            "train.batch_size": 8, "train.accum_steps": 2,
            "train.n_epoch": 1, "train.zero1": True,
            "train.eval_sample_count": 2, "train.eval_every": 1,
            "train.min_save_ep": 0, "train.save_freq": 1}
FIT_CFG = preset("full", **FIT_OVER, **{"train.mesh_data": 2})
RESUME_CFG = preset("full", **{**FIT_OVER, "train.mesh_data": 2,
                               "train.n_epoch": 2, "train.min_save_ep": 100,
                               "train.save_freq": 100})


@contextlib.contextmanager
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _one_process(cfg):
    """``cfg`` as one process runs it (no data axis to split)."""
    return cfg.replace(train=dataclasses.replace(cfg.train, mesh_data=-1))


def _bn_inputs():
    """{net: inputs} for ``torch_parallel_ranks.bn_net``."""
    rng = np.random.RandomState(3)
    return {"block": (rng.randn(4, 3, 16, 16).astype(np.float32) * 2 + 1,),
            "net": (rng.randn(4, 32, 32, 3).astype(np.float32),
                    np.array([0, 1, 2, 1]), rng.rand(4).astype(np.float32),
                    np.array([1.0, 0.0, 1.0, 1.0], np.float32),
                    rng.choice([0.5, 1.0, 3.0], (4, 32, 32)).astype(
                        np.float32))}


def _train_inputs():
    """The train-step test's inputs: configs, the tiny net (its initial
    weights as a torch state dict and as flax trees), two wire batches,
    the JAX step's draws, and the spatial helpers' input."""
    cfg = preset("full", **TINY, **STEP_OVER)
    model = ranks.tiny_model(cfg)
    return {"cfgs": {"rep": cfg, "zero1": cfg.replace(
                train=dataclasses.replace(cfg.train, zero1=True))},
            "model": model,
            "before": {n: p.detach().clone()
                       for n, p in model.named_parameters()},
            "params": flax_from_state_dict(model.state_dict())[0],
            "batches": [wire_batch(0), wire_batch(1)],
            "draws": [_step_draws(jax.random.PRNGKey(s), cfg.diffusion)
                      for s in STEP_SEEDS],
            "spatial": tuple(np.asarray(a) for a in spatial_input())}


def _start_jax_side(base):
    """``jax_parallel_side`` in a process of its own (through ``conftest``
    for the 8 CPU devices): the file's longest path, so it starts first
    and holds no interpreter lock of this process."""
    tests = os.path.dirname(os.path.abspath(__file__))
    code = (f"import sys; sys.path[:0] = [{tests!r}]; import conftest; "
            f"import jax_parallel_side as j; j.main({str(base)!r})")
    return subprocess.Popen([sys.executable, "-c", code], cwd=tests,
                            stdout=subprocess.DEVNULL,
                            stderr=open(base / "jax_side.log", "wb"))


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """Everything that can run beside the rest, started at the first test
    that asks: the JAX side (a process), the 4-rank train-step group, the
    2-rank BatchNorm and sampler group, and the 2-rank ``fit`` group,
    which also resumes the one-process run's checkpoint (written here
    first). Yields (base dir, train inputs, the one-process fit's params,
    ``get(name)`` -> a group's results or the JAX side's)."""
    base = tmp_path_factory.mktemp("parallel")
    jax_proc = _start_jax_side(base)
    inputs = _train_inputs()
    with open(base / "jax_in.tmp", "wb") as f:
        pickle.dump(inputs["params"], f)
    os.replace(base / "jax_in.tmp", base / "jax_in.pkl")
    started = {
        "train": (ranks.spawn(
            ranks.train_step_ranks, RANKS, base, inputs["spatial"],
            inputs["cfgs"], inputs["batches"], inputs["draws"]), RANKS),
        "bn_sampler": (ranks.spawn(ranks.bn_sampler_ranks, 2, base, BN_CFG,
                                   _bn_inputs(), SAMPLER_RUNS), 2)}
    with one_thread():
        one = ranks.fit_run(_one_process(FIT_CFG), base / "one")
    started["fit"] = (ranks.spawn(ranks.fit_ranks, 2, base, FIT_CFG,
                                  RESUME_CFG, str(base),
                                  str(base / "one" / "ckpt_ep0")), 2)
    done = {}

    def get(name):
        if name == "jax":
            rc = jax_proc.wait(timeout=600)
            assert rc == 0, (base / "jax_side.log").read_text()[-4000:]
            with open(base / "jax_side.pkl", "rb") as f:
                return pickle.load(f)
        if name not in done:
            (ctx, out), world = started[name]
            done[name] = ranks.join(ctx, out, world)
        return done[name]

    yield base, inputs, one, get
    for name, ((ctx, _), _) in started.items():
        if name not in done:
            for p in ctx.processes:
                p.kill()
    jax_proc.kill()
    jax_proc.wait()


def _flat(tree):
    return np.concatenate([np.ravel(np.asarray(v))
                           for v in jax.tree.leaves(tree)])


def _port_flat(params):
    return _flat(flax_from_state_dict(params)[0])


# ------------------------------------------------------ rules, no processes
def _ids_model():
    """The tiny flagship with every parameter element set to a unique
    integer (exact in float32), and its flax trees through the bridge."""
    model = ranks.tiny_model(preset("full", **TINY))
    sd, start = {}, 0
    for name, p in model.named_parameters():
        sd[name] = (torch.arange(p.numel(), dtype=torch.float32) + start
                    ).reshape(p.shape)
        start += p.numel()
    return model, sd, flax_from_state_dict(sd)[0]


def _blocks(arr, dim, n):
    """The n blocks of ``arr`` along ``dim``, as sets of element ids."""
    k = arr.shape[dim] // n
    return [set(np.ravel(np.take(arr, range(r * k, (r + 1) * k), axis=dim))
                .tolist()) for r in range(n)]


def _jax_dims(shardings, axis):
    """Per leaf, the flax dim partitioned over ``axis``, or None."""
    return [None if axis not in tuple(sh.spec) else tuple(sh.spec).index(axis)
            for sh in jax.tree.leaves(shardings)]


def test_sharding_rules_pick_the_jax_dims(started):
    """``opt_state_shardings`` (ZeRO-1, data 2 / 4 / 8) and
    ``param_shardings`` (model 2) give every process the same elements of
    every leaf as the JAX package's rules on the tiny flagship: leaves
    matched through the bridge, blocks compared element by element."""
    model, sd, tree = _ids_model()
    leaves = jax.tree.leaves(tree)
    name_of = {int(sd[n].reshape(-1).min()): n for n in sd}
    jtree = jax.tree.map(jnp.asarray, tree)
    partitioned = {}
    for n_data in (2, 4, 8):
        jm = jmake_mesh(data=n_data, model=1)
        jdims = _jax_dims(jopt_shardings(jm, {"mu": jtree})["mu"], "data")
        mine = opt_state_shardings(
            Mesh({"data": n_data, "model": 1, "spatial": 1}), model)
        partitioned[n_data] = _check_same_blocks(leaves, jdims, mine, sd,
                                                 name_of, n_data)
    assert partitioned[2] > 0 and partitioned[8] > 0, partitioned
    jm = jmake_mesh(data=4, model=2)
    jdims = _jax_dims(jparam_shardings(jm, jtree, min_channels=64), "model")
    mine = param_shardings(Mesh({"data": 4, "model": 2, "spatial": 1}),
                           model, min_channels=64)
    assert _check_same_blocks(leaves, jdims, mine, sd, name_of, 2) > 0


def _check_same_blocks(leaves, jdims, mine, sd, name_of, n) -> int:
    count = 0
    for arr, jd in zip(leaves, jdims):
        name = name_of[int(arr.reshape(-1).min())]
        sh = mine[name]
        td = sh.dims[0][0] if sh.dims else None
        assert (jd is None) == (td is None), (name, jd, td)
        if jd is None:
            continue
        count += 1
        assert _blocks(np.asarray(arr), jd, n) == _blocks(
            sd[name].numpy(), td, n), name
    return count


def test_unported_axes_and_meshes_are_refused(tmp_path):
    """No mesh setting runs silently on one process: a data, model or
    spatial axis larger than the process group (none here) is an
    error."""
    from diffusionmodel_tpu_torch.trainer import fit

    base = {**TINY, "train.save_dir": str(tmp_path)}
    for over, err, said in (({"train.mesh_model": 2}, ValueError,
                             "needs 2 processes"),
                            ({"train.mesh_spatial": 2}, ValueError,
                             "needs 2 processes"),
                            ({"train.mesh_data": 2}, ValueError,
                             "needs 2 processes")):
        with pytest.raises(err, match=said):
            fit(preset("full", **base, **over), device="cpu")
    assert not any(tmp_path.iterdir())


# ------------------------------------- spatial helpers and the train step
def _step_draws(key, dc):
    """The draws the JAX train step takes from its key for the global
    batch, per micro-batch (as ``tests/test_torch_trainer.py``)."""
    out = []
    for _ in range(A):
        key, sub = jax.random.split(key)
        lkey, _ = jax.random.split(sub)
        tkey, nkey, mkey = jax.random.split(lkey, 3)
        out.append(dict(
            ts=np.array(jax.random.randint(tkey, (B,), 1, dc.n_T + 1)),
            noise=np.array(jax.random.normal(nkey, (B, 32, 32, 3),
                                             jnp.float32)),
            ctx_mask=np.array(jax.random.bernoulli(
                mkey, 1.0 - dc.drop_prob, (B,)).astype(jnp.float32))))
    return out


def _assert_param_parity(got, want, before):
    """tests/test_torch_trainer.py's distribution of |port - JAX| against
    the step size: median <= 1% of lr, 99th percentile <= 5%."""
    off = np.abs(got - want)
    assert np.median(np.abs(want - before)) > 0.5 * LR
    assert np.median(off) <= 0.01 * LR, np.median(off)
    assert np.percentile(off, 99) <= 0.05 * LR, np.percentile(off, 99)


def test_spatial_helpers_and_train_step_over_four_ranks(started):
    """Four gloo ranks, each holding its block of the 'data' axis:

    - the spatial helpers on H-slabs of JAX's ``test_spatial_sharding_pools``
      input against JAX's helpers (rtol 1e-5, atol 1e-6);
    - two train steps (A = 2 micro-batches of 4, one sample per rank),
      replicated and ZeRO-1, from the same weights and JAX's draws:
      each against JAX's mesh step in the same layout (loss within 1e-5
      relative, parameters by the parity distribution), against the
      port's one-process step (loss within 1e-6 relative, parameters
      within 1e-2 of the update's norm), ZeRO-1 against replicated after
      the first step (max |dparam| < 1e-5, JAX's own bound), every rank
      with the same parameters and holding only its block of each
      partitioned moment, and the moments rank 0 gathers for a
      checkpoint whole."""
    _, inputs, _, get = started
    cfgs, model = inputs["cfgs"], inputs["model"]
    with one_thread():
        one = ranks.train_steps(cfgs["rep"], inputs["batches"],
                                inputs["draws"])
    got = get("train")
    jx = get("jax")
    want_spatial = jx["spatial"]
    assert not any(r["jax_imported"] for r in got)

    tol = dict(rtol=1e-5, atol=1e-6)
    for r in got:
        np.testing.assert_allclose(r["mean"].numpy(), want_spatial["mean"],
                                   **tol)
        np.testing.assert_allclose(r["x_w"].numpy(),
                                   want_spatial["pools"][1], **tol)
    np.testing.assert_allclose(
        torch.cat([r["se"] for r in got], 1).numpy(), want_spatial["se"],
        **tol)
    np.testing.assert_allclose(
        torch.cat([r["x_h"] for r in got], 1).numpy(),
        want_spatial["pools"][0], **tol)

    before = _port_flat(inputs["before"])
    one_flat = _port_flat(one["params"])
    update = np.linalg.norm(one_flat - before)
    for name in cfgs:
        mine = got[0]["steps"][name]
        for r in got[1:]:
            theirs = r["steps"][name]
            assert theirs["losses"] == mine["losses"]
            assert all(torch.equal(theirs["params"][n], p)
                       for n, p in mine["params"].items()), name
        flat = _port_flat(mine["params"])
        jlosses, jparams = jx["step"][name]
        np.testing.assert_allclose(mine["losses"], jlosses, rtol=1e-5,
                                   err_msg=name)
        _assert_param_parity(flat, _flat(jparams), before)
        np.testing.assert_allclose(mine["losses"], one["losses"], rtol=1e-6,
                                   err_msg=name)
        assert np.linalg.norm(flat - one_flat) <= 1e-2 * update, name

    # ZeRO-1: each rank holds 1/4 of every moment the rule partitions
    rule = opt_state_shardings(Mesh({"data": RANKS, "model": 1,
                                     "spatial": 1}), model)
    sizes = [p.numel() for p in model.parameters()]
    for r in got:
        z1 = r["steps"]["zero1"]
        for size, sh, (mu, nu) in zip(sizes, rule.values(),
                                      z1["moment_numel"]):
            assert (mu, nu) == ((size // RANKS,) * 2 if sh.dims
                                else (size, size))
        assert all(n == (s, s) for n, s in zip(r["steps"]["rep"]
                                               ["moment_numel"], sizes))
    assert sum(bool(sh.dims) for sh in rule.values()) > 10
    # rank 0 gathers whole moments; the others get None
    z1_host, rep_host = (got[0]["steps"][k]["opt_host"]
                         for k in ("zero1", "rep"))
    assert all(r["steps"]["zero1"]["opt_host"] is None for r in got[1:])
    for k in ("mu", "nu"):
        assert all(z1_host[k][n].shape == m.shape
                   for n, m in rep_host[k].items())
        z, r = (np.concatenate([np.ravel(h[k][n]) for n in sorted(h[k])])
                for h in (z1_host, rep_host))
        assert np.linalg.norm(z - r) <= 1e-3 * np.linalg.norm(r), k
    z1_first = _port_flat(got[0]["steps"]["zero1"]["first"])
    rep_first = _port_flat(got[0]["steps"]["rep"]["first"])
    assert np.abs(z1_first - rep_first).max() < 1e-5


# ---------------------------------------------- BatchNorm and the samplers
@pytest.mark.parametrize("which", ["block", "net"])
def test_batchnorm_over_two_ranks_matches_one_process(started, which):
    """Train-mode BatchNorm under a data group normalises with the global
    batch's statistics (one all_reduce, the gradient carried through it):
    two ranks of 2 against one process of 4, outputs, gradients (averaged
    over the ranks) and running statistics, each bound scaled by the
    largest output or gradient where that is above 1. A conv / BatchNorm
    / GELU / conv / BatchNorm block within 1e-6; the tiny net with
    ``norm="batch"`` (nine BatchNorms deep) within 1e-4, its statistics
    within 1e-6. In one process, the same
    batch through this normalisation and through ``F.batch_norm`` lands
    2e-5 and 3e-5 apart (float32 sums in another order, grown by the
    depth), and the two ranks 6e-6 and 7e-6 from one."""
    _, _, _, get = started
    got = get("bn_sampler")
    with one_thread():
        out, grads, stats = ranks.bn_forward_backward(
            which, BN_CFG, _bn_inputs()[which])
    rel = 1e-6 if which == "block" else 1e-4
    out_tol = rel * max(1.0, out.abs().max().item())
    grad_tol = rel * max(1.0, *(g.abs().max().item() for g in grads.values()))
    assert not any(r["jax_imported"] for r in got)
    for r in got:
        r_out, r_grads, r_stats = r["bn"][which]
        np.testing.assert_allclose(r_out.numpy(), out.numpy(), rtol=0,
                                   atol=out_tol)
        assert r_stats.keys() == stats.keys() and stats
        for n, v in stats.items():
            np.testing.assert_allclose(r_stats[n].numpy(), v.numpy(),
                                       rtol=0, atol=1e-6, err_msg=n)
        for n, g in grads.items():
            np.testing.assert_allclose(r_grads[n].numpy(), g.numpy(),
                                       rtol=0, atol=grad_tol, err_msg=n)


@pytest.mark.parametrize("name", [n for n, _, _ in SAMPLER_RUNS])
def test_sampler_fan_out_matches_one_process(started, name):
    """``make_sampler(mesh=)`` over two ranks: each denoises its half of
    the slots from the global draws and the halves are gathered, equal to
    one process (ancestral over n_T 12, DDIM-4 with eta 0.5, DPM++-4, the
    textbook sampler) within the JAX package's bounds for its mesh sampler
    (rtol 2e-4, atol 1e-5, 5e-5 for DPM++): PyTorch's CPU convolutions sum
    a batch of 8 otherwise than one of 16 (max |d| 2.1e-5 ancestral,
    1.2e-5 DDIM, 2.8e-5 DPM++ measured here); a slot or noise out of
    place would be O(1). 7 slots do not split in two, so both ranks sample
    all 7, as the JAX package falls back to replication: bit for bit."""
    _, _, _, get = started
    got = get("bn_sampler")
    cfg, n = next((c, k) for nm, c, k in SAMPLER_RUNS if nm == name)
    with one_thread():
        want = ranks.run_sampler(cfg, n, seed=7).numpy()
    for r in got:
        imgs = r["samples"][name].numpy()
        assert imgs.shape == want.shape and np.isfinite(imgs).all()
        if name == "uneven":
            np.testing.assert_array_equal(imgs, want)
        np.testing.assert_allclose(imgs, want, rtol=2e-4,
                                   atol=5e-5 if name == "dpmpp" else 1e-5)


# ------------------------------------------------------------ fit, 2 ranks
def test_fit_over_two_ranks_with_zero1(started):
    """``fit`` with ``mesh_data=2`` and ``zero1`` (n_feat 8, 32 px, one
    epoch, in-loop sampling): only rank 0 writes (each rank was given its
    own save_dir); the losses match the one-process run within 1e-5
    relative, the parameters within 1e-2 of the epoch's update (norms,
    as in the train-step test); the ZeRO-1 checkpoint resumes on two
    ranks and on one process, and the one-process checkpoint on two ranks,
    to the same second epoch."""
    base, _, one, get = started
    got = get("fit")
    assert not any(r["jax_imported"] for r in got)
    assert got[0]["mesh"]["data"] == 2
    rank0 = base / "fit_rank0"
    assert (rank0 / "ckpt_ep0" / "payload.pkl").exists()
    assert list(rank0.glob("img_ep0_w*.png"))
    assert not (base / "fit_rank1").exists()
    assert not any(base.glob("resume_*_rank1"))
    one_losses = ranks._metrics_losses(base / "one", 0)
    np.testing.assert_allclose(got[0]["losses"], one_losses, rtol=1e-5)
    torch.manual_seed(FIT_CFG.train.seed)
    initial = _port_flat(dict(build_model(dataclasses.replace(
        FIT_CFG.model, n_classes=2), device="cpu").named_parameters()))
    want = _port_flat(one)
    for r in got:
        assert np.linalg.norm(_port_flat(r["params"]) - want) <= 1e-2 * \
            np.linalg.norm(want - initial)
    sources = {"own": rank0 / "ckpt_ep0",
               "one_process": base / "one" / "ckpt_ep0"}
    assert got[0]["resumed_losses"].keys() == sources.keys()
    for name, src in sources.items():
        with one_thread():
            resumed = ranks.fit_run(_one_process(RESUME_CFG),
                                    base / f"resume_{name}_one",
                                    resume=str(src))
        np.testing.assert_allclose(
            got[0]["resumed_losses"][name],
            ranks._metrics_losses(base / f"resume_{name}_one", 1),
            rtol=1e-5, err_msg=name)
        want = _port_flat(resumed)
        for r in got:
            assert np.linalg.norm(_port_flat(r["resumed"][name]) - want) \
                <= 1e-2 * np.linalg.norm(want - initial), name
