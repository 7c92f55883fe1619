"""The port's training pieces against the JAX package (CPU, float32): the
loss and its gradients, the LR schedules, the optimizer, and the stale
CoordAttn weight cache after an optimizer step.

The tiny ContextUnet of ``tests/test_kernels.py:67`` (n_feat 16, 32 px, 3
classes) starts from the port's PyTorch initialisation; the JAX trees come
from it through the port's ``flax_from_state_dict`` (held here to the
structure of the JAX model's own init). The JAX package's ``jax.random``
draws are replayed into the port. JAX functions are jitted once per module
(the XLA compiles dominate this file's time)."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from diffusionmodel_tpu import lr_schedules as jlr
from diffusionmodel_tpu.config import preset as jpreset
from diffusionmodel_tpu.diffusion import Schedule as JSchedule
from diffusionmodel_tpu.diffusion import train_loss as jtrain_loss
from diffusionmodel_tpu.nn import build_model as jbuild_model
from diffusionmodel_tpu_torch import lr_schedules as tlr
from diffusionmodel_tpu_torch.compat.flax_bridge import (
    flax_from_state_dict,
    state_dict_from_flax,
)
from diffusionmodel_tpu_torch.config import preset
from diffusionmodel_tpu_torch.diffusion import Schedule, train_loss
from diffusionmodel_tpu_torch import train as ttrain
from diffusionmodel_tpu_torch.nn import build_model
from diffusionmodel_tpu_torch.train import (
    Optimizer,
    apply_updates_,
    create_train_state,
    init_opt_state,
    make_train_step,
    remat_denoiser,
)

torch.set_num_threads(2)

TINY = {"model.n_feat": 16, "model.img_size": 32, "model.n_classes": 3}
B = 2
# Loss and gradients: the same fp32 network summed in other orders by two
# frameworks (PARITY.md's full-model tolerance is rtol 5e-3 / atol 1e-4 on
# outputs; a mean over outputs is tighter).
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-5


def _cfg(**kw):
    return preset("full", **TINY, **kw)


def _port_model(cfg, seed=0):
    torch.manual_seed(seed)
    return build_model(cfg.model, cfg.diffusion.high_thresh, device="cpu")


@pytest.fixture(scope="module")
def tiny():
    """The port's tiny net and its weights as JAX trees."""
    model = _port_model(_cfg())
    params, stats = flax_from_state_dict(model.state_dict())
    assert stats == {}
    return model, params


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(3)
    x = rng.uniform(-1, 1, (B, 32, 32, 3)).astype(np.float32)
    mask = rng.choice(np.float32([0.5, 1.0, 3.0]), (B, 32, 32))
    return x, np.array([0, 2], np.int32), mask


def _draws(key, shape, dc):
    """The draws ``diffusion.train_loss`` takes from its key
    (``diffusion.py:91-112``): t, eps and the context mask."""
    tkey, nkey, mkey = jax.random.split(key, 3)
    p = 1.0 - dc.drop_prob if dc.use_weighted_loss else dc.drop_prob
    return dict(
        ts=np.array(jax.random.randint(tkey, (shape[0],), 1, dc.n_T + 1)),
        noise=np.array(jax.random.normal(nkey, shape, dtype=jnp.float32)),
        ctx_mask=np.array(jax.random.bernoulli(mkey, p, (shape[0],))
                          .astype(jnp.float32)))


def test_flax_from_state_dict_matches_the_jax_init_tree(tiny):
    """The inverse bridge builds exactly the JAX model's parameter tree."""
    _, params = tiny
    cfg = jpreset("full", **TINY)
    model = jbuild_model(cfg.model, cfg.diffusion.high_thresh)
    want = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                           jnp.zeros((1,), jnp.int32), jnp.zeros((1,)),
                           jnp.ones((1,)), attn_mask=jnp.ones((1, 32, 32)),
                           train=True))["params"]
    assert jax.tree.structure(want) == jax.tree.structure(params)
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(params)):
        assert w.shape == g.shape and g.dtype == np.float32


def test_host_copies_do_not_follow_the_live_weights():
    """``flax_from_state_dict`` (snapshots, checkpoint payloads) and the
    optimizer state's host form are copies: on the CPU a tensor's
    ``.numpy()`` shares its memory, and an in-place update after the copy
    must not reach a snapshot or a checkpoint being written."""
    cfg = _cfg()
    model = _port_model(cfg)
    state, opt = create_train_state(model, cfg, 1)
    params, _ = flax_from_state_dict(model.state_dict())
    host = ttrain.opt_state_to_host(model, state.opt_state)
    before = [np.copy(a) for a in jax.tree.leaves(params)]
    with torch.no_grad():
        torch._foreach_add_(list(model.parameters()), 1.0)
        torch._foreach_add_(state.opt_state.nu, 1.0)
    for a, b in zip(jax.tree.leaves(params), before):
        np.testing.assert_array_equal(a, b)
    assert all(np.all(v == 0) for v in host["nu"].values())


@pytest.mark.parametrize("weighted", [True, False],
                         ids=["weighted", "mnist_form"])
def test_train_loss_and_gradients_match_jax(tiny, batch, weighted):
    """``train_loss`` and every parameter gradient against
    ``jax.value_and_grad`` of the JAX ``train_loss`` on the same weights,
    with the JAX key's draws replayed: the weighted MSE + feature
    consistency with the spatial mask sent to the net, and the MNIST form
    (plain MSE, drop-mask)."""
    model, params = tiny
    model = copy.deepcopy(model).train()
    over = {} if weighted else {"diffusion.use_weighted_loss": False,
                                "diffusion.feat_consist_weight": 0.0}
    jcfg, cfg = jpreset("full", **TINY, **over), _cfg(**over)
    dc = cfg.diffusion
    jmodel = jbuild_model(jcfg.model, dc.high_thresh)
    jsched = JSchedule.create(dc.beta1, dc.beta2, dc.n_T)
    x, c, mask = batch
    key = jax.random.PRNGKey(11)

    def loss(p):
        def apply_fn(xt, cc, t, ctx, attn, train):
            return jmodel.apply({"params": p}, xt, cc, t, ctx,
                                attn_mask=attn, train=True)

        return jtrain_loss(apply_fn, key, jnp.asarray(x), jnp.asarray(c),
                           jnp.asarray(mask), jsched, jcfg.diffusion)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss))(params)
    draws = _draws(key, x.shape, dc)
    got = train_loss(model, torch.from_numpy(x), torch.from_numpy(c).long(),
                     torch.from_numpy(mask), Schedule.create(
                         dc.beta1, dc.beta2, dc.n_T, "cpu"), dc, **draws)
    got.backward()
    np.testing.assert_allclose(got.item(), float(jloss), rtol=LOSS_RTOL)
    want = state_dict_from_flax(jax.tree.map(np.asarray, jgrads))
    named = dict(model.named_parameters())
    assert set(want) == set(named)
    for name, w in want.items():
        np.testing.assert_allclose(named[name].grad.numpy(), w.numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def test_textbook_loss_is_not_ported(batch):
    """The textbook family's branch, ported since: the network gets x_t on
    the textbook schedule's abar at the given t in [0, n_T), the raw
    timesteps, a zero context mask and no spatial mask; plain MSE. (Held
    to the JAX package in tests/test_torch_side_families.py.)"""
    from diffusionmodel_tpu_torch.models.annotated_ddpm.diffusion import (
        textbook_schedule,
    )

    dc = dataclasses.replace(_cfg().diffusion, schedule_family="textbook")
    sched = textbook_schedule(dc.n_T, dc.beta1, dc.beta2, "cpu")
    g = torch.Generator().manual_seed(0)
    x = torch.rand((2, 4, 4, 3), generator=g)
    noise = torch.randn((2, 4, 4, 3), generator=g)
    ts = [0, dc.n_T - 1]
    seen = {}

    def apply(x_t, c, t, ctx, attn):
        seen.update(x_t=x_t, t=t, ctx=ctx, attn=attn)
        return torch.full_like(x_t, 0.5)

    loss = train_loss(apply, x, torch.zeros(2), None, sched, dc, ts=ts,
                      noise=noise)
    ab = sched.alpha_bar[torch.tensor(ts)][:, None, None, None]
    torch.testing.assert_close(seen["x_t"], torch.sqrt(ab) * x
                               + torch.sqrt(1.0 - ab) * noise)
    assert seen["t"].tolist() == [float(t) for t in ts]
    assert seen["ctx"].tolist() == [0.0, 0.0] and seen["attn"] is None
    torch.testing.assert_close(loss, torch.mean((noise - 0.5) ** 2))


@pytest.mark.parametrize("kind", ["cosine_warm_restarts", "linear", "none"])
def test_lr_schedules_match_jax(kind):
    """Each schedule at optimizer steps 0-300 (3 steps per epoch, so the
    SGDR cycles of 10, 20, 40 epochs restart inside the range), float32
    values equal to the JAX package's."""
    kw = dict(n_epoch=150, t0=10, t_mult=2, eta_min=3e-5)
    want_fn = jlr.build_schedule(kind, 1e-4, 3, **kw)
    got_fn = tlr.build_schedule(kind, 1e-4, 3, **kw)
    counts = np.arange(301, dtype=np.int32)
    want = np.asarray(jax.vmap(want_fn)(jnp.asarray(counts)), np.float32)
    got = np.array([got_fn(int(n)) for n in counts], np.float32)
    np.testing.assert_allclose(got, np.broadcast_to(want, got.shape),
                               rtol=2e-7, atol=0)
    with pytest.raises(ValueError):
        tlr.build_schedule("nope", 1e-4, 3, n_epoch=1)


@pytest.mark.parametrize("name", ["adamw_bf16_mu", "adam_f32_mu"])
def test_optimizer_matches_optax(name):
    """``apply_updates_`` against ``optax.chain(clip_by_global_norm(1),
    adamw(schedule, 1e-2, mu_dtype=bf16))`` (and ``adam`` with fp32
    moments) for 5 steps on random trees: gradient scales from 1e-6 to 10
    so that some steps clip and some do not. Tolerance rtol 1e-6 / atol
    5e-7 on parameters of magnitude <= 3 (a few float32 ulps): the same
    float32 ops, which XLA fuses (fma) where PyTorch rounds each one; an
    update is ~3e-2, so this is ~1e-5 of one update."""
    adamw = name.startswith("adamw")
    mu_dtype = jnp.bfloat16 if adamw else None
    sched = jlr.cosine_warm_restarts(3e-2, 1, t0=2)
    inner = (optax.adamw(sched, weight_decay=1e-2, mu_dtype=mu_dtype)
             if adamw else optax.adam(sched, mu_dtype=mu_dtype))
    tx = optax.chain(optax.clip_by_global_norm(1.0), inner)
    rng = np.random.RandomState(0)
    shapes = {"w": (5, 7), "b": (7,), "k": (3, 3, 2, 4)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    jp = jax.tree.map(jnp.asarray, params)
    jstate = tx.init(jp)

    @jax.jit
    def update(grads, state, p):
        updates, state = tx.update(grads, state, p)
        return optax.apply_updates(p, updates), state

    keys = sorted(shapes)
    tp = [torch.nn.Parameter(torch.from_numpy(params[k].copy()))
          for k in keys]
    opt = Optimizer(tlr.cosine_warm_restarts(3e-2, 1, t0=2),
                    1e-2 if adamw else 0.0, 1.0,
                    torch.bfloat16 if adamw else torch.float32)
    st = init_opt_state(opt, tp)
    clipped = []
    for i in range(5):
        scale = 10.0 ** rng.uniform(-6, 1)
        grads = {k: (rng.randn(*s) * scale).astype(np.float32)
                 for k, s in shapes.items()}
        clipped.append(float(optax.global_norm(grads)) >= 1.0)
        jp, jstate = update(jax.tree.map(jnp.asarray, grads), jstate, jp)
        apply_updates_(opt, st, tp, [torch.from_numpy(grads[k].copy())
                                     for k in keys])
        for k, p in zip(keys, tp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=5e-7,
                                       err_msg=f"step {i} {k}")
    assert any(clipped) and not all(clipped)
    adam_state = jstate[1][0]
    assert st.count == int(adam_state.count) == 5
    for k, m, v in zip(keys, st.mu, st.nu):
        assert m.dtype == (torch.bfloat16 if adamw else torch.float32)
        np.testing.assert_allclose(m.float().numpy(), np.asarray(
            adam_state.mu[k], np.float32), rtol=1e-2 if adamw else 1e-6,
            atol=1e-8)
        np.testing.assert_allclose(v.numpy(), np.asarray(adam_state.nu[k]),
                                   rtol=1e-6)


def test_remat_policy_is_validated():
    model = torch.nn.Linear(2, 2)
    for policy in ("full", "conv", "dots"):
        assert remat_denoiser(model, False, policy) is model
    with pytest.raises(ValueError, match="remat_policy"):
        remat_denoiser(model, True, "nope")


def _wire_batch(rng, a=1):
    return {"x": rng.randint(0, 256, (a, B, 32, 32, 3)).astype(np.uint8),
            "c": rng.randint(0, 3, (a, B)).astype(np.int32),
            "mask": rng.randint(0, 3, (a, B, 32, 32)).astype(np.uint8)}


def _eval_forward(model, inputs):
    with torch.no_grad():
        return model.eval()(*inputs)


def test_coord_attn_cache_follows_an_optimizer_step():
    """No stale CoordAttn packing after a step, on the CPU: a
    ``use_pallas=True`` model runs an eval forward (which caches
    CoordAttn's packed weights), one train step, and another eval forward;
    the last equals a fresh model loaded with the new ``state_dict``. Updating through ``.data`` (which leaves the version
    counters alone) would keep the cache stale: the last assertion shows
    the check sees that."""
    cfg = _cfg(**{"model.use_pallas": True, "train.accum_steps": 1,
                  "train.lr": 1e-2})
    dc = cfg.diffusion
    model = _port_model(cfg)
    rng = np.random.RandomState(5)
    inputs = (torch.from_numpy(rng.randn(B, 32, 32, 3).astype(np.float32)),
              torch.tensor([0, 1]), torch.full((B,), 0.4), torch.ones(B))
    before = _eval_forward(model, inputs)
    assert model.ca1.__dict__.get("_packed_cache") is not None
    state, opt = create_train_state(model, cfg, 1)
    step = make_train_step(model, Schedule.create(
        dc.beta1, dc.beta2, dc.n_T, "cpu"), cfg, opt)
    step(state, _wire_batch(rng), torch.Generator().manual_seed(0))
    after = _eval_forward(model, inputs)
    fresh = _port_model(cfg, seed=1)
    fresh.load_state_dict(model.state_dict())
    want = _eval_forward(fresh, inputs)
    assert not torch.equal(after, before)
    torch.testing.assert_close(after, want, rtol=0, atol=0)

    with torch.no_grad():
        model.ca1.conv_h.weight.data.add_(0.5)
    stale = _eval_forward(model, inputs)
    fresh.load_state_dict(model.state_dict())
    assert not torch.equal(stale, _eval_forward(fresh, inputs))
