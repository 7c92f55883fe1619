"""The port's train step, data, training loop, generation and CLI against
the JAX package (CPU, float32).

The tiny ContextUnet of ``tests/test_kernels.py:67`` (n_feat 16, 32 px, 3
classes); the JAX trees come from the port's weights through
``flax_from_state_dict``. The JAX train step and forwards are jitted once
per module (their XLA compiles dominate this file's time). The crack
dataset fixture is the one of ``tests/test_data.py:41``."""

import os
import sys
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusionmodel_tpu import checkpoint as jckpt
from diffusionmodel_tpu import data as jdata
from diffusionmodel_tpu.config import preset as jpreset
from diffusionmodel_tpu.diffusion import Schedule as JSchedule
from diffusionmodel_tpu.diffusion import q_sample as jq_sample
from diffusionmodel_tpu.nn import build_model as jbuild_model
from diffusionmodel_tpu.train import TrainState as JTrainState
from diffusionmodel_tpu.train import build_optimizer as jbuild_optimizer
from diffusionmodel_tpu.train import make_train_step as jmake_train_step
from diffusionmodel_tpu.utils import grid as jgrid
from diffusionmodel_tpu_torch import data as tdata
from diffusionmodel_tpu_torch import train as ttrain
from diffusionmodel_tpu_torch.compat.flax_bridge import (
    flax_from_state_dict,
    state_dict_from_flax,
)
from diffusionmodel_tpu_torch.config import preset
from diffusionmodel_tpu_torch.diffusion import Schedule, sample_cfg_dpmpp
from diffusionmodel_tpu_torch.nn import build_model
from diffusionmodel_tpu_torch.sample import gen_samples
from diffusionmodel_tpu_torch.train import create_train_state, make_train_step
from diffusionmodel_tpu_torch.trainer import fit

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

torch.set_num_threads(2)

TINY = {"model.n_feat": 16, "model.img_size": 32, "model.n_classes": 3}
A, B = 2, 2
# Three steps from the same weights and draws: the same fp32 network and
# Adam summed in other orders by two frameworks. Losses within rtol 1e-4.
# Parameters and EMA: Adam divides each gradient element by its running
# RMS, so gradients that agree to ~1e-3 relative (test_torch_train.py)
# move a parameter by up to a whole step (lr) apart where an element is
# near zero and its rounding decides its sign. So the check is on the
# distribution of |port - JAX| against the step size lr = 1e-4: median
# <= 1% of lr, 99th percentile <= 5% of lr, none beyond the 2 lr a step
# can move apart in 3 steps. (Measured: 1.7e-7, 2.3e-6, 3.4e-4.)
LOSS_RTOL = 1e-4
LR = 1e-4


def _cfg(**kw):
    return preset("full", **TINY, **kw)


def _port_model(cfg, seed=0):
    torch.manual_seed(seed)
    return build_model(cfg.model, cfg.diffusion.high_thresh, device="cpu")


def _sched(dc):
    return Schedule.create(dc.beta1, dc.beta2, dc.n_T, "cpu")


def _wire_batch(seed, a=A):
    rng = np.random.RandomState(seed)
    return {"x": rng.randint(0, 256, (a, B, 32, 32, 3)).astype(np.uint8),
            "c": rng.randint(0, 3, (a, B)).astype(np.int32),
            "mask": rng.randint(0, 3, (a, B, 32, 32)).astype(np.uint8)}


def _step_draws(key, a, dc):
    """The draws the JAX train step takes from its key, per micro-batch
    (``train.py:246-254``, ``:192``, ``diffusion.py:91-112``)."""
    out = []
    for _ in range(a):
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


def _flat(tree):
    return np.concatenate([np.ravel(np.asarray(v))
                           for v in jax.tree.leaves(tree)])


def _assert_steps_close(got_tree, want_tree, before_tree, what):
    got, want, before = (_flat(t) for t in (got_tree, want_tree,
                                            before_tree))
    assert np.median(np.abs(want - before)) > 0.5 * LR, f"{what} barely moved"
    off = np.abs(got - want)
    assert np.median(off) <= 0.01 * LR, (what, np.median(off))
    assert np.percentile(off, 99) <= 0.05 * LR, (what,
                                                 np.percentile(off, 99))
    assert off.max() <= 3 * 2 * LR, (what, off.max())


@pytest.fixture(scope="module")
def jax_steps():
    """Three steps of the JAX package's ``make_train_step`` (A=2 micro
    batches of 2, uint8 wire batches, EMA 0.99, AdamW with bf16 first
    moment, clip 1.0, SGDR at one step per epoch) from the port's initial
    weights; ``remat`` off (the same math; it only changes what the
    backward keeps). Returns the port's initial weights as the tiny
    model, the trees before, and per step (key, loss, params, ema)."""
    over = {"train.accum_steps": A, "train.batch_size": B,
            "train.ema_decay": 0.99, "train.lr": LR}
    cfg = _cfg(**over)
    jcfg = jpreset("full", **TINY, **over, **{"train.remat": False})
    model = _port_model(cfg)
    params, _ = flax_from_state_dict(model.state_dict())
    jmodel = jbuild_model(jcfg.model, jcfg.diffusion.high_thresh)
    dc = jcfg.diffusion
    tx = jbuild_optimizer(jcfg, 1)
    jp = jax.tree.map(jnp.asarray, params)
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=jp,
                        batch_stats={}, opt_state=tx.init(jp),
                        ema_params=jax.tree.map(jnp.array, jp))
    step = jax.jit(jmake_train_step(jmodel, JSchedule.create(
        dc.beta1, dc.beta2, dc.n_T), jcfg, tx, has_bn=False))
    out = []
    for i in range(3):
        key = jax.random.PRNGKey(40 + i)
        state, loss = step(state, jax.tree.map(jnp.asarray, _wire_batch(i)),
                           key)
        out.append((key, float(loss),
                    jax.tree.map(np.asarray, state.params),
                    jax.tree.map(np.asarray, state.ema_params)))
    return cfg, model, params, out


def test_three_train_steps_match_jax(jax_steps):
    """``make_train_step`` (remat on, the default) for three steps against
    the JAX package's: the loss of each, then the parameters and the EMA
    shadow after the last."""
    cfg, model, before, steps = jax_steps
    model = _port_model(cfg)
    state, opt = create_train_state(model, cfg, 1)
    assert cfg.train.remat and cfg.train.remat_policy == "full"
    step = make_train_step(model, _sched(cfg.diffusion), cfg, opt)
    for i, (key, jloss, _, _) in enumerate(steps):
        loss = step(state, _wire_batch(i),
                    draws=_step_draws(key, A, cfg.diffusion))
        np.testing.assert_allclose(loss.item(), jloss, rtol=LOSS_RTOL,
                                   err_msg=f"step {i}")
    assert state.step == 3 and state.opt_state.count == 3
    assert not model.training
    _, _, jparams, jema = steps[-1]
    _assert_steps_close(flax_from_state_dict(model.state_dict())[0], jparams,
                        before, "params")
    _assert_steps_close(flax_from_state_dict(state.ema.state_dict())[0],
                        jema, before, "ema")


def _one_step(cfg, capture=None, monkeypatch=None, seed=0):
    model = _port_model(cfg)
    state, opt = create_train_state(model, cfg, 1)
    if capture is not None:
        real = ttrain.apply_updates_

        def spy(opt, st, params, grads):
            capture.append([g.clone() for g in grads])
            return real(opt, st, params, grads)

        monkeypatch.setattr(ttrain, "apply_updates_", spy)
    step = make_train_step(model, _sched(cfg.diffusion), cfg, opt)
    key = jax.random.PRNGKey(50 + seed)
    loss = step(state, _wire_batch(seed),
                draws=_step_draws(key, A, cfg.diffusion))
    return model, loss


@pytest.mark.parametrize("remat", ["none", "full", "conv", "dots"])
def test_remat_policies_give_the_no_remat_step(remat):
    """One step under each ``remat_policy`` equals the step without
    recomputation: the recomputed forward is the same CPU arithmetic."""
    base = {"train.accum_steps": A, "train.batch_size": B}
    ref, ref_loss = _one_step(_cfg(**base, **{"train.remat": False}))
    over = ({"train.remat": False} if remat == "none" else
            {"train.remat": True, "train.remat_policy": remat})
    got, loss = _one_step(_cfg(**base, **over))
    assert loss.item() == ref_loss.item()
    for (n, p), q in zip(got.named_parameters(), ref.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=n)


def test_bf16_gradient_accumulator(monkeypatch):
    """``grad_accum_dtype="bfloat16"``: the micro-batch gradients are cast
    to bf16 and summed in bf16, and the float32 mean of that sum reaches
    the optimizer, exactly as the JAX step's scan carry does."""
    base = {"train.accum_steps": A, "train.batch_size": B,
            "train.remat": False}
    f32, b16 = [], []
    _one_step(_cfg(**base), f32, monkeypatch)
    _one_step(_cfg(**base, **{"train.grad_accum_dtype": "bfloat16"}), b16,
              monkeypatch)
    # per micro-batch gradients, from the float32 run's draws
    cfg = _cfg(**base)
    model = _port_model(cfg)
    batch = _wire_batch(0)
    draws = _step_draws(jax.random.PRNGKey(50), A, cfg.diffusion)
    per = []
    for i in range(A):
        x, mask = ttrain.decode_wire(torch.from_numpy(batch["x"][i]),
                                     torch.from_numpy(batch["mask"][i]),
                                     cfg.diffusion, True)
        model.train()
        ttrain.train_loss(model, x, torch.from_numpy(batch["c"][i]).long(),
                          mask, _sched(cfg.diffusion), cfg.diffusion,
                          **draws[i]).backward()
        per.append([p.grad.clone() for p in model.parameters()])
        model.zero_grad(set_to_none=True)
    for k, (g32, g16) in enumerate(zip(f32[0], b16[0])):
        torch.testing.assert_close(g32, (per[0][k] + per[1][k]) / A,
                                   rtol=0, atol=0)
        acc = per[0][k].bfloat16() + per[1][k].bfloat16()
        torch.testing.assert_close(g16, acc.float() / A, rtol=0, atol=0)
    assert any(not torch.equal(a, b) for a, b in zip(f32[0], b16[0]))


def test_batchnorm_running_stats_match_flax():
    """A v1 ``norm="batch"`` net: after one step of two micro-batches the
    BatchNorm running statistics equal flax's ``batch_stats`` after two
    train-mode forwards on the same inputs (flax updates the running
    variance with the biased batch variance; stock ``nn.BatchNorm2d``
    would be off by n/(n-1)). Tolerance rtol 1e-5 / atol 1e-6: variances
    of the same activations computed in another order."""
    over = {"model.arch": "context_unet_v1", "model.norm": "batch",
            "model.use_local_enhancer": False, "train.accum_steps": A,
            "train.batch_size": B}
    cfg = _cfg(**over)
    dc = cfg.diffusion
    model = _port_model(cfg)
    params, stats = flax_from_state_dict(model.state_dict())
    jmodel = jbuild_model(jpreset("full", **TINY, **over).model,
                          dc.high_thresh)
    jsched = JSchedule.create(dc.beta1, dc.beta2, dc.n_T)
    batch = _wire_batch(7)
    draws = _step_draws(jax.random.PRNGKey(60), A, dc)

    @jax.jit
    def forward(bs, x_t, c, t, ctx):
        _, upd = jmodel.apply({"params": params, "batch_stats": bs}, x_t, c,
                              t, ctx, train=True, mutable=["batch_stats"])
        return upd["batch_stats"]

    bs = stats
    for i in range(A):
        x = (batch["x"][i].astype(np.float32) / 255.0 - 0.5) / 0.5
        d = draws[i]
        x_t = jq_sample(jsched, jnp.asarray(x), jnp.asarray(d["ts"]),
                        jnp.asarray(d["noise"]))
        bs = forward(bs, x_t, jnp.asarray(batch["c"][i]),
                     jnp.asarray(d["ts"] / dc.n_T, jnp.float32),
                     jnp.asarray(d["ctx_mask"]))
    state, opt = create_train_state(model, cfg, 1)
    make_train_step(model, _sched(dc), cfg, opt)(state, batch, draws=draws)
    got = flax_from_state_dict(model.state_dict())[1]
    assert jax.tree.structure(got) == jax.tree.structure(bs)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(bs)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-6)
    assert model.init_conv.conv1[1].num_batches_tracked.item() == A


# ------------------------------------------------------------------- data
def _write_xml(path, bbox, size=(64, 64)):
    root = ET.Element("annotation")
    sz = ET.SubElement(root, "size")
    ET.SubElement(sz, "width").text = str(size[0])
    ET.SubElement(sz, "height").text = str(size[1])
    bb = ET.SubElement(ET.SubElement(root, "object"), "bndbox")
    for k, v in zip(("xmin", "ymin", "xmax", "ymax"), bbox):
        ET.SubElement(bb, k).text = str(v)
    ET.ElementTree(root).write(path)


def _fake_root(base, classes=("alligator_0", "pothole_1"), per=6):
    """``tests/test_data.py:41``'s layout: JPEGs per class with VOC XML,
    and one orphan image without XML."""
    root = base / "cropped"
    (root / "annotations").mkdir(parents=True)
    rng = np.random.RandomState(0)
    for cls in classes:
        (root / "images" / cls).mkdir(parents=True)
        for i in range(per):
            stem = f"{cls}_{i}"
            Image.fromarray(rng.randint(0, 255, (64, 64, 3), np.uint8)).save(
                root / "images" / cls / f"{stem}.jpg")
            _write_xml(str(root / "annotations" / f"{stem}.xml"),
                       (10 + i, 20, 40, 50 - i))
    Image.new("RGB", (64, 64)).save(root / "images" / classes[0]
                                    / "orphan.jpg")
    return str(root)


def test_crack_data_matches_jax(tmp_path, monkeypatch):
    """``CrackDataset`` (scan, ``load``, ``load_wire`` with seeded flips,
    co-flipped masks), ``stratified_split`` (sklearn and the numpy
    fallback) and ``BatchLoader`` (tail batch wrap-padded, uint8 wire and
    float) against the JAX package's modules: every array bit-identical."""
    root = _fake_root(tmp_path)
    kw = dict(img_size=32, hflip_prob=0.5, co_flip_mask=True, seed=3)
    mk = (lambda mod: mod.CrackDataset(root, **kw))
    want, got = mk(jdata), mk(tdata)
    assert got.classes == want.classes and len(got) == len(want) == 12
    np.testing.assert_array_equal(got.labels, want.labels)
    for i in range(len(want)):
        for fn, aug in (("load", False), ("load", True),
                        ("load_wire", True)):
            w, g = getattr(want, fn)(i, augment=aug), \
                getattr(got, fn)(i, augment=aug)
            assert g[1] == w[1]
            np.testing.assert_array_equal(g[0], w[0])
            np.testing.assert_array_equal(g[2], w[2])
    np.testing.assert_array_equal(tdata.build_attn_mask(32, (5, 6, 40, 50),
                                                        (64, 48)),
                                  jdata.build_attn_mask(32, (5, 6, 40, 50),
                                                        (64, 48)))

    labels = np.repeat(np.arange(5), 5)
    tr, va = tdata.stratified_split(labels, 0.2, 42)
    jtr, jva = jdata.stratified_split(labels, 0.2, 42)
    np.testing.assert_array_equal(tr, jtr)
    np.testing.assert_array_equal(va, jva)
    monkeypatch.setitem(sys.modules, "sklearn.model_selection", None)
    tr, va = tdata.stratified_split(labels, 0.1, 42)
    jtr, jva = jdata.stratified_split(labels, 0.1, 42)
    np.testing.assert_array_equal(tr, jtr)
    np.testing.assert_array_equal(va, jva)
    assert len(va) == 5  # one per class

    # 11 = 2 full batches of 4 and a wrap-padded tail. Flips draw from the
    # dataset's one RandomState, so with worker threads their order is the
    # threads'; augmented batches are compared on the synchronous path.
    idx = np.arange(11)
    for wire, aug, workers in ((True, True, 0), (False, True, 0),
                               (True, False, 2)):
        loaders = [mod.BatchLoader(mod.CrackDataset(root, **kw), idx, 2, 2,
                                   seed=5, augment=aug, num_workers=workers,
                                   wire_u8=wire)
                   for mod in (jdata, tdata)]
        wb, gb = (list(ld) for ld in loaders)
        assert len(gb) == len(wb) == 3
        for w, g in zip(wb, gb):
            assert set(g) == set(w) == {"x", "c", "mask"}
            for k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
        assert gb[0]["x"].dtype == (np.uint8 if wire else np.float32)


def test_crack_dataset_from_arrays_matches_files(tmp_path):
    """``CrackDataset.from_arrays`` on the decoded pixels and boxes of the
    file fixture gives the file-backed dataset's classes, labels, ``load``
    and ``load_wire`` (seeded flips, co-flipped masks) bit for bit, and
    refuses images that are not uint8 [N, S, S, 3]."""
    root = _fake_root(tmp_path)
    kw = dict(hflip_prob=0.5, co_flip_mask=True, seed=3)
    files = tdata.CrackDataset(root, img_size=32, **kw)
    decoded = [files._decoded(i) for i in range(len(files))]
    assert len({d[2] for d in decoded}) == 1
    mem = tdata.CrackDataset.from_arrays(
        np.stack([d[0] for d in decoded]), [d[1] for d in decoded],
        files.labels, files.classes, orig_wh=decoded[0][2], **kw)
    files = tdata.CrackDataset(root, img_size=32, **kw)  # fresh flip rng
    assert mem.classes == files.classes and len(mem) == len(files)
    np.testing.assert_array_equal(mem.labels, files.labels)
    for i in range(len(files)):
        for fn, aug in (("load", False), ("load", True),
                        ("load_wire", True)):
            w, g = getattr(files, fn)(i, augment=aug), \
                getattr(mem, fn)(i, augment=aug)
            assert g[1] == w[1]
            np.testing.assert_array_equal(g[0], w[0])
            np.testing.assert_array_equal(g[2], w[2])
    with pytest.raises(ValueError, match="uint8"):
        tdata.CrackDataset.from_arrays(np.zeros((1, 8, 8, 3), np.float32),
                                       [(0, 0, 4, 4)], [0], ["a"])


def test_decode_wire_matches_the_float_path():
    dc = _cfg().diffusion
    ds_u8 = np.random.RandomState(1).randint(0, 256, (2, 8, 8, 3)).astype(
        np.uint8)
    m_u8 = np.random.RandomState(2).randint(0, 3, (2, 8, 8)).astype(np.uint8)
    x, m = ttrain.decode_wire(torch.from_numpy(ds_u8),
                              torch.from_numpy(m_u8), dc, True)
    want_x = (ds_u8.astype(np.float32) / 255.0 - 0.5) / 0.5
    np.testing.assert_array_equal(x.numpy(), want_x)
    np.testing.assert_array_equal(
        m.numpy(), np.float32([0.5, 1.0, 3.0])[m_u8])


# ------------------------------------------------- loop, generation, CLI
def _loop_cfg(tmp_path, **kw):
    over = {"train.n_epoch": 1, "train.batch_size": 2, "train.accum_steps": 2,
            "train.min_save_ep": 0, "train.val_split": 0.25,
            "train.eval_every": 1, "train.ema_decay": 0.9,
            "train.save_dir": str(tmp_path / "run"),
            "sample.sampler": "dpmpp", "sample.dpm_steps": 2,
            "sample.guide_scales": (2.0,),
            "sample.sample_dir": str(tmp_path / "samples"),
            "diffusion.n_T": 50, "model.use_pallas": True}
    over.update(kw)
    return _cfg(**over)


def _jax_forward(params, x, c, t, ctx):
    jcfg = jpreset("full", **TINY)
    jmodel = jbuild_model(jcfg.model, jcfg.diffusion.high_thresh)
    return np.asarray(jax.jit(lambda p: jmodel.apply(
        {"params": p}, x, c, t, ctx, train=False))(params))


def test_fit_checkpoint_loads_in_jax_and_resumes(tmp_path, capsys):
    """A one-epoch ``fit`` writes ``ckpt_ep0`` that the JAX package's
    ``load_checkpoint`` reads: numpy trees, whose JAX forward matches the
    port's model (rtol 5e-3 / atol 1e-4, PARITY.md's full-model
    tolerance), the metrics JSON with the JAX schema, and ``--resume``
    restoring the port's own optimizer state; then ``fit`` resumes from a
    checkpoint the JAX package wrote (optax state: skipped, as the JAX
    trainer does with foreign state) with its weights bit-exact."""
    root = _fake_root(tmp_path, classes=("a", "b", "c"), per=4)
    cfg = _loop_cfg(tmp_path).replace(data_root=root)
    state = fit(cfg, device="cpu", verbose=False)
    run = tmp_path / "run"
    assert sorted(os.listdir(run)) == ["best_model", "best_val.json",
                                       "ckpt_ep0", "img_ep0_w2.0.png",
                                       "metrics"]
    import json

    log = json.load(open(run / "metrics" / "metrics_ep0.json"))
    assert set(log) == {"train_loss", "val_loss", "img_metrics", "lr",
                        "steps_per_sec"}
    # the JAX schema with 3 collected eval images: SSIM and PSNR (FID
    # needs 10 per side), the scale, the epoch and the rate
    assert set(log["img_metrics"][0]) == {"ssim", "psnr", "guide_scale",
                                          "epoch", "images_per_min"}
    assert all(np.isfinite(log["img_metrics"][0][k]) for k in ("ssim",
                                                                 "psnr"))
    ck = jckpt.load_checkpoint(str(run / "ckpt_ep0"))
    assert ck["epoch"] == 0 and set(ck["opt_state"]) == {"count", "mu", "nu"}
    rng = np.random.RandomState(9)
    x = rng.randn(2, 32, 32, 3).astype(np.float32)
    c, t, ctx = np.array([0, 2]), np.full(2, 0.3, np.float32), np.ones(2)
    want = _jax_forward(jckpt.extract_params(ck, prefer_ema=False),
                        jnp.asarray(x), jnp.asarray(c), jnp.asarray(t),
                        jnp.asarray(ctx))
    with torch.no_grad():
        got = state.model.eval()(torch.from_numpy(x), torch.from_numpy(c),
                                 torch.from_numpy(t), torch.from_numpy(ctx))
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-3, atol=1e-4)
    for a, b in zip(jax.tree.leaves(ck["ema_params"]),
                    jax.tree.leaves(flax_from_state_dict(
                        state.ema.state_dict())[0])):
        np.testing.assert_array_equal(a, b)

    again = fit(cfg, device="cpu", verbose=True,
                resume=str(run / "ckpt_ep0"))
    assert again.step == 1 * 3 and again.opt_state.count == ck["opt_state"][
        "count"] > 0
    for m, (n, _) in zip(again.opt_state.mu, again.model.named_parameters()):
        np.testing.assert_array_equal(m.float().numpy(), ck["opt_state"][
            "mu"][n])
    capsys.readouterr()

    # a checkpoint the JAX package wrote: its optax state, its writer
    jcfg = jpreset("full", **TINY)
    jparams, _ = flax_from_state_dict(_port_model(cfg, seed=3).state_dict())
    tx = jbuild_optimizer(jcfg, 1)
    jpath = jckpt.save_checkpoint(str(tmp_path / "jax_ckpt"), {
        "epoch": 0, "params": jparams, "batch_stats": {},
        "opt_state": tx.init(jax.tree.map(jnp.asarray, jparams)),
        "loss": 1.0})
    resumed = fit(cfg, device="cpu", verbose=True, resume=jpath)
    out = capsys.readouterr().out
    assert "opt_state restore skipped" in out
    assert f"Resumed from {jpath} at epoch 1" in out
    want_sd = state_dict_from_flax(jparams)
    for n, p in resumed.model.state_dict().items():
        torch.testing.assert_close(p, want_sd[n], rtol=0, atol=0, msg=n)
    for n, p in resumed.ema.state_dict().items():
        torch.testing.assert_close(p, want_sd[n], rtol=0, atol=0, msg=n)


def test_gen_samples_block_order_files_and_pixels(tmp_path):
    """``gen_samples`` with pinned x_T: classes block-ordered (each image
    equals the sampler run directly on block-ordered classes), per-class
    file names, the one-batch sweep equal to per-scale runs, and PNGs
    whose pixels equal the JAX package's ``utils/grid.py`` (PIL) output
    for the same arrays."""
    cfg = _loop_cfg(tmp_path, **{"sample.samples_per_class": 2})
    model = _port_model(cfg, seed=4)
    params, _ = flax_from_state_dict(model.state_dict())
    ema, _ = flax_from_state_dict(_port_model(cfg, seed=5).state_dict())
    path = jckpt.save_checkpoint(str(tmp_path / "ck.pkl"), {
        "epoch": 0, "params": params, "ema_params": ema, "batch_stats": {}})
    x_init = np.random.RandomState(6).randn(6, 32, 32, 3).astype(np.float32)
    res = gen_samples(cfg, path, guide_scales=[2.0, 4.0], eval_quality=False,
                      device="cpu", x_init=x_init, verbose=False)
    names = sorted(os.listdir(res["out_dir"]))
    assert names == sorted([f"class_{k}_s{i}_g{w}.png" for k in range(3)
                            for i in range(2) for w in (2.0, 4.0)]
                           + ["samples_g2.0.png", "samples_g4.0.png"])
    ema_model = _port_model(cfg, seed=5)  # EMA preferred
    dc = cfg.diffusion
    want = sample_cfg_dpmpp(ema_model.eval(), None, 6, (32, 32, 3), 3,
                            _sched(dc), dc, guide_w=4.0, n_steps=2,
                            classes=torch.tensor([0, 0, 1, 1, 2, 2]),
                            x_init=x_init).numpy()
    np.testing.assert_allclose(res[4.0]["images"], want, rtol=1e-5,
                               atol=1e-5)
    loop = gen_samples(cfg, path, guide_scales=[2.0, 4.0],
                       eval_quality=False, device="cpu", x_init=x_init,
                       verbose=False, sweep_one_batch=False)
    for w in (2.0, 4.0):
        np.testing.assert_allclose(loop[w]["images"], res[w]["images"],
                                   rtol=1e-5, atol=1e-5)
        assert res[w]["seconds"] > 0 and res[w]["images_per_min"] > 0
    imgs = res[2.0]["images"]
    jgrid.save_samples(imgs, str(tmp_path / "jax_grid.png"), nrow=2)
    jgrid.save_image(imgs[3], str(tmp_path / "jax_one.png"), denorm=True)
    for ours, theirs in (("samples_g2.0.png", "jax_grid.png"),
                         ("class_1_s1_g2.0.png", "jax_one.png")):
        np.testing.assert_array_equal(
            np.asarray(Image.open(os.path.join(res["out_dir"], ours))),
            np.asarray(Image.open(tmp_path / theirs)))


def test_gen_samples_scores_quality_like_jax(tmp_path):
    """With a dataset, ``gen_samples`` scores every scale by default: real
    images drawn as the JAX package draws them (a seeded permutation,
    ``n_per * min(n_classes, 4)`` of them), ``quality_metrics.json`` with
    the JAX schema, and the values the JAX ``ImageMetrics`` gives on the
    same real and generated images (6 per side: SSIM and PSNR only)."""
    import json

    from diffusionmodel_tpu.metrics import ImageMetrics as JImageMetrics

    root = _fake_root(tmp_path, classes=("a", "b", "c"), per=3)
    cfg = _loop_cfg(tmp_path, **{"sample.samples_per_class": 2}).replace(
        data_root=root)
    params, _ = flax_from_state_dict(_port_model(cfg, seed=4).state_dict())
    path = jckpt.save_checkpoint(str(tmp_path / "ck.pkl"), {
        "epoch": 0, "params": params, "batch_stats": {}})
    res = gen_samples(cfg, path, guide_scales=[2.0, 4.0], device="cpu",
                      verbose=False, seed=5)
    doc = json.load(open(os.path.join(res["out_dir"],
                                      "quality_metrics.json")))
    assert set(doc) == {"2.0", "4.0"}
    ds = jdata.CrackDataset(root, img_size=32)
    order = np.random.RandomState(5).permutation(len(ds))[:6]
    real = np.stack([ds.load(int(i))[0] for i in order])
    for w in (2.0, 4.0):
        want = JImageMetrics().evaluate_batch(real, res[w]["images"])
        assert doc[str(w)] == res["quality"][w] == want


def test_cli_train_then_generate(tmp_path):
    """``--mode train`` then ``--mode generate`` on its checkpoint, on the
    CPU; unset ``--epochs`` keeps the preset's n_epoch."""
    from diffusionmodel_tpu_torch import cli

    root = _fake_root(tmp_path, classes=("a", "b", "c"), per=4)
    common = ["--device", "cpu", "--data_root", root,
              "-o", "model.n_feat=16", "-o", "model.img_size=32",
              "-o", "diffusion.n_T=20", "-o",
              f"sample.sample_dir={tmp_path / 'samples'}"]
    args = cli.build_parser().parse_args(["--mode", "train"] + common)
    assert cli._config(args).train.n_epoch == 400
    assert cli.main(["--mode", "train", "--epochs", "1", "--save_dir",
                     str(tmp_path / "run"), "-o", "train.min_save_ep=0",
                     "-o", "train.val_split=0.25", "-o", "train.eval_every=0",
                     "-o", "train.batch_size=2", "-o", "train.accum_steps=1"]
                    + common) == 0
    ckpt = tmp_path / "run" / "ckpt_ep0"
    assert (ckpt / "payload.pkl").exists()
    assert cli.main(["--mode", "generate", "--ckpt", str(ckpt), "--sampler",
                     "dpmpp", "--steps", "2", "--samples", "1",
                     "--no_eval"] + common) == 0
    out_dir = next((tmp_path / "samples").iterdir())
    assert sorted(os.listdir(out_dir)) == sorted(
        [f"{k}_s0_g{w}.png" for k in "abc" for w in (2.0, 4.0)]
        + ["samples_g2.0.png", "samples_g4.0.png"])
    assert cli.main(["--mode", "generate"] + common) == 1
    with pytest.raises(FileNotFoundError, match="inception_weights"):
        cli.main(["--mode", "train", "--inception_weights",
                  str(tmp_path / "x.npz")] + common)
