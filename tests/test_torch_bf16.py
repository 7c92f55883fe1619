"""The port's bfloat16 compute (``model.dtype="bfloat16"``) against the
JAX package's on the same weights and inputs (CPU).

The JAX side is compiled to round where its program (the jaxpr) rounds:
with XLA's default the CPU compiler keeps some bf16 intermediates in
float32 (excess precision), depending on how it fuses, which no other
program can follow (``_jit``). The port rounds at the same sites.

Each comparison is held to JAX's own bf16 gap g = relL2(JAX-bf16,
JAX-fp32), which must exceed 1e-3: a block of the port within 0.25 g of
JAX-bf16. Two bf16 programs that round at the same sites still part where
their float32 sums (convolutions, means) round differently, about one
element in 1e5 per layer, and a network carries those flips forward: a
block fed JAX's inputs stays within 0.25 g (every stage of the whole
model, fed JAX's own stage input, is held so), while the whole forward,
chained, ends near g (0.86-0.91 g here, in eval, train and fused form),
nearer than XLA's default compile of the same JAX program lands from the
jaxpr-rounding one (1.18-1.22 g; the slow compile-spread test). So the
chained forward is held to be no further from JAX-bf16 than that,
nearer to it than JAX-fp32 is (g), and at least 0.5 g from the port's
own float32 forward, so that it cannot be computing in float32.

JAX compiles of the whole tiny net dominate this file's time (6-26 s
each): the quick tier compiles one (the bf16 eval forward with every
stage's output) and takes float32 references from the port's own float32
net, which the float32 tests hold to JAX to 1e-5; the comparisons that
need more whole-net compiles (train mode, the fused head, the gradients,
the DDIM sampler) are marked slow.

The kernels' bf16 twins are held to the Pallas kernels in interpret mode
(with the exact-erf GELU the port uses in place of the kernels' tanh
form): one bf16 ulp of |y|, except where a float32 sum rounds the other
way."""

import contextlib
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusionmodel_tpu import checkpoint as jckpt
from diffusionmodel_tpu.compat.torch_convert import _Mapper
from diffusionmodel_tpu.config import preset as jpreset
from diffusionmodel_tpu.diffusion import Schedule as JSchedule
from diffusionmodel_tpu.diffusion import train_loss as jtrain_loss
from diffusionmodel_tpu.kernels import coord_attn as jca
from diffusionmodel_tpu.kernels import se_block as jse
from diffusionmodel_tpu.nn import blocks as jb
from diffusionmodel_tpu.nn import build_model as jbuild_model
from diffusionmodel_tpu.nn.coord_attn import CoordAttn as JCoordAttn
from diffusionmodel_tpu.trainer import make_sampler as jmake_sampler
from diffusionmodel_tpu_torch.compat.flax_bridge import state_dict_from_flax
from diffusionmodel_tpu_torch.config import preset
from diffusionmodel_tpu_torch.diffusion import Schedule, train_loss
from diffusionmodel_tpu_torch.kernels.coord_attn import (
    CoordAttnWeights,
    coord_attn,
)
from diffusionmodel_tpu_torch.kernels.se_block import se_block
from diffusionmodel_tpu_torch.nn import blocks as tb
from diffusionmodel_tpu_torch.nn import build_model
from diffusionmodel_tpu_torch.nn.coord_attn import CoordAttn
from diffusionmodel_tpu_torch.train import create_train_state, make_train_step
from diffusionmodel_tpu_torch.trainer import make_sampler

torch.set_num_threads(2)

BF16 = torch.bfloat16
TINY = {"model.n_feat": 16, "model.img_size": 32, "model.n_classes": 5}
BLOCK_FACTOR = 0.25
NOT_FP32_FACTOR = 0.5


def _jit(fn, *args):
    """``jax.jit(fn)(*args)`` rounding where the jaxpr rounds."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _nchw(a, dtype=torch.float32):
    return tb.channels_last(torch.from_numpy(np.asarray(a, np.float32))
                            .permute(0, 3, 1, 2)).to(dtype)


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _gap(j16, j32):
    g = _rel(j16, j32)
    assert g > 1e-3, f"JAX's bf16 gap {g:.2e} too small to test against"
    return g


# --- blocks ---------------------------------------------------------------

def _randomize(mod, seed):
    """Non-trivial CoordAttn scalars and GroupNorm affines (float32
    parameters that the bf16 program uses in float32 or in bf16)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in mod.named_parameters():
            leaf = name.split(".")[-1]
            if leaf in ("gamma_h", "gamma_w", "alpha", "beta"):
                p.copy_(torch.randn(p.shape, generator=g))
        for m in mod.modules():
            if isinstance(m, tb.GroupNorm):
                m.weight.copy_(1 + 0.2 * torch.randn(m.weight.shape,
                                                      generator=g))
                m.bias.copy_(0.2 * torch.randn(m.bias.shape, generator=g))


def _block_case(name):
    """(port module factory taking dtype, JAX module factory taking dtype,
    mapper fill, input shapes, extra kwargs)."""
    if name == "ResConvBlock":
        return (lambda dt: tb.ResConvBlock(16, 16, is_res=True, dtype=dt),
                lambda dt: jb.ResConvBlock(16, 16, is_res=True, dtype=dt),
                lambda m: m.resconv(("b",), "b", "group", True),
                [(2, 8, 8, 16)])
    if name == "UnetDown":
        return (lambda dt: tb.UnetDown(16, 32, dtype=dt),
                lambda dt: jb.UnetDown(16, 32, dtype=dt),
                lambda m: m.unet_down_v2(("b",), "b", "group"),
                [(2, 16, 16, 16)])
    if name.startswith("UnetUp"):
        fused = name.endswith("fused")
        return (lambda dt: tb.UnetUp(64, 16, dtype=dt, fused_upsample=fused),
                lambda dt: jb.UnetUp(64, 16, dtype=dt, fused_upsample=fused),
                lambda m: m.unet_up_v2(("b",), "b", "group"),
                [(2, 8, 8, 32), (2, 8, 8, 32)])
    if name == "CoordAttn":
        return (lambda dt: CoordAttn(32, 16, dtype=dt),
                lambda dt: JCoordAttn(32, 16, dtype=dt),
                lambda m: m.coord_attn(("b",), "b", "group"),
                [(2, 8, 8, 32)])
    if name == "SEBlock":
        def fill(m):
            m.dense(("b", "Dense_0"), "b.fc.0")
            m.dense(("b", "Dense_1"), "b.fc.2")
        return (lambda dt: tb.SEBlock(64, 16, dtype=dt),
                lambda dt: jb.SEBlock(64, 16, dtype=dt), fill,
                [(2, 8, 8, 64)])
    if name == "LocalEnhancer":
        return (lambda dt: tb.LocalEnhancer(16, 1.2, dtype=dt),
                lambda dt: jb.LocalEnhancer(16, 1.2, dtype=dt),
                lambda m: m.local_enhancer(("b",), "b"),
                [(2, 8, 8, 16)])
    raise KeyError(name)


BLOCKS = ["ResConvBlock", "UnetDown", "UnetUp", "UnetUp_fused", "CoordAttn",
          "SEBlock", "LocalEnhancer"]


def _block_runs(name, precast=False, train=True):
    """(JAX at bf16, JAX at fp32, the port at bf16) for one block on the
    same randomized weights and inputs. ``precast``: JAX's parameters
    cast to bf16 first (its bf16 sampler's ``_precast``) and the port
    under ``precast_params``."""
    make, jmake, fill, shapes = _block_case(name)
    torch.manual_seed(7)
    port32 = make(torch.float32)
    _randomize(port32, 8)
    sd = {f"b.{k}": v.detach().numpy() for k, v in port32.state_dict().items()}
    mapper = _Mapper(sd)
    fill(mapper)
    params = mapper.params["b"]
    rng = np.random.RandomState(9)
    inputs = [rng.randn(*s).astype(np.float32) for s in shapes]
    extra = {}
    if name == "LocalEnhancer":
        extra = {"mask": (rng.rand(2, 8, 8) * 2).astype(np.float32)}

    def run_jax(dt):
        mod = jmake(dt)
        args = [jnp.asarray(a).astype(dt) for a in inputs]
        kw = {k: jnp.asarray(v) for k, v in extra.items()}
        if name not in ("LocalEnhancer",):
            kw["train"] = train
        p = params
        if precast and dt == jnp.bfloat16:
            p = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
        return _jit(lambda p, *a: mod.apply({"params": p}, *a, **kw),
                    p, *args)

    port = make(BF16)
    port.load_state_dict(port32.state_dict())
    port.train(train)
    with torch.no_grad(), (tb.precast_params(port) if precast
                           else contextlib.nullcontext()):
        kw = {k: torch.from_numpy(v) for k, v in extra.items()}
        got = port(*[_nchw(a, BF16) for a in inputs], **kw)
    assert all(p.dtype == torch.float32 for p in port.parameters())
    return run_jax(jnp.bfloat16), run_jax(jnp.float32), got


@pytest.mark.parametrize("name", BLOCKS)
def test_bf16_block_matches_jax(name):
    """Each block at bf16 (train mode: SE's own path, not the kernel's)
    within 0.25 g of the JAX block at bf16, in JAX's output type (float32
    for CoordAttn, whose float32 scalars promote; bf16 elsewhere)."""
    j16, j32, got = _block_runs(name)
    g = _gap(_f32(j16), _f32(j32))
    want_dtype = torch.float32 if j16.dtype == jnp.float32 else BF16
    assert got.dtype == want_dtype
    err = _rel(_nhwc(got), _f32(j16))
    assert err <= BLOCK_FACTOR * g, (err, g)


@pytest.mark.parametrize("name", ["CoordAttn", "ResConvBlock"])
def test_bf16_precast_block_matches_jax(name):
    """Under ``precast_params`` (what the port's bf16 ``make_sampler``
    runs in) a block follows the JAX block whose parameters are cast to
    bf16 first, as JAX's bf16 sampler casts them (eval mode): within
    0.25 g, in JAX's output type (bf16: CoordAttn's bf16 scalars no longer
    promote); the norms' affine rounded to bf16 in ResConvBlock. Without
    the precast CoordAttn lands further from it (float32 scalars)."""
    j16, j32, got = _block_runs(name, precast=True, train=False)
    g = _gap(_f32(j16), _f32(j32))
    assert j16.dtype == jnp.bfloat16 and got.dtype == BF16
    err = _rel(_nhwc(got), _f32(j16))
    assert err <= BLOCK_FACTOR * g, (err, g)
    if name == "CoordAttn":
        _, _, plain = _block_runs(name, precast=False, train=False)
        assert _rel(_nhwc(plain), _f32(j16)) > err


# --- the whole model --------------------------------------------------------

STAGES = ["init_conv", "down1", "ca1", "down2", "ca2", "down3", "ca3",
          "down4", "ca4"]


@pytest.fixture(scope="module")
def tiny():
    """JAX's tiny flagship (seed-0 init), the port's copy of its weights,
    and one batch of inputs."""
    cfg = jpreset("full", **TINY)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 32, 32, 3).astype(np.float32)
    c = np.array([0, 3], np.int32)
    t = np.array([0.3, 0.97], np.float32)
    ctx = np.array([1.0, 0.0], np.float32)
    mask = (rng.rand(2, 32, 32) * 2).astype(np.float32)
    jm = jbuild_model(cfg.model)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x),
                              jnp.asarray(c), jnp.asarray(t),
                              jnp.asarray(ctx))["params"]
    return dict(params=params, x=x, c=c, t=t, ctx=ctx, mask=mask,
                sd=state_dict_from_flax(params, {}))


def _jax_model(over):
    cfg = jpreset("full", **TINY, **over)
    return jbuild_model(cfg.model, cfg.diffusion.high_thresh)


def _port_model(tiny, over):
    cfg = preset("full", **TINY, **over)
    m = build_model(cfg.model, cfg.diffusion.high_thresh, device="cpu")
    m.load_state_dict(tiny["sd"])
    return m


def _port_forward(model, tiny, train):
    model.train(train)
    with torch.no_grad():
        return model(torch.from_numpy(tiny["x"]), torch.from_numpy(tiny["c"]),
                     torch.from_numpy(tiny["t"]),
                     torch.from_numpy(tiny["ctx"]),
                     torch.from_numpy(tiny["mask"]) if train else None)


@pytest.fixture(scope="module")
def jax_eval(tiny):
    """JAX's bf16 eval forward with every module's output, and the port's
    float32 eval forward with its stages' outputs (the float32 reference:
    the float32 tests hold the port to JAX there to 1e-5)."""
    jm = _jax_model({"model.dtype": "bfloat16"})
    args = [jnp.asarray(tiny[k]) for k in ("x", "c", "t", "ctx")]
    y, st = _jit(lambda p: jm.apply(
        {"params": p}, *args, capture_intermediates=True,
        mutable=["intermediates"]), tiny["params"])
    model = _port_model(tiny, {}).eval()
    stages = {}
    hooks = [getattr(model, n).register_forward_hook(
        lambda mod, i, o, n=n: stages.__setitem__(n, _nhwc(o)))
        for n in STAGES]
    p32 = _port_forward(model, tiny, False).numpy()
    for h in hooks:
        h.remove()
    return dict(j16=_f32(y), i16=st["intermediates"], p32=p32,
                stages32=stages)


def test_bf16_model_stages_match_jax(tiny, jax_eval):
    """Every stage of the port's bf16 eval forward, fed JAX-bf16's input
    to that stage, within 0.25 g of JAX-bf16's output of it (g the stage's
    own bf16 gap), in JAX's type (CoordAttn float32, the rest bf16)."""
    model = _port_model(tiny, {"model.dtype": "bfloat16"}).eval()
    assert model.dtype == BF16
    i16 = jax_eval["i16"]
    prev = None
    for name in STAGES:
        want = i16[name]["__call__"][0]
        if prev is None:
            inp = _nchw(tiny["x"])
        else:
            a = i16[prev]["__call__"][0]
            inp = _nchw(_f32(a), BF16 if a.dtype == jnp.bfloat16
                        else torch.float32)
        with torch.no_grad():
            got = getattr(model, name)(inp)
        assert got.dtype == (BF16 if want.dtype == jnp.bfloat16
                             else torch.float32), name
        g = _gap(_f32(want), jax_eval["stages32"][name])
        err = _rel(_nhwc(got), _f32(want))
        assert err <= BLOCK_FACTOR * g, (name, err, g)
        prev = name


def _check_chained(p16, p32, j16, spread=None):
    """The chained bf16 forward against JAX-bf16 (see the module note)."""
    assert p16.dtype == BF16 and p32.dtype == torch.float32
    got, ref32 = p16.float().numpy(), p32.numpy()
    g = _gap(j16, ref32)
    err = _rel(got, j16)
    assert err < g, (err, g)
    if spread is not None:
        assert err <= spread, (err, spread)
    assert _rel(got, ref32) >= NOT_FP32_FACTOR * g


def test_bf16_model_matches_jax(tiny, jax_eval):
    """The whole bf16 eval forward, chained: nearer to JAX-bf16 than
    float32 is (g), and at least 0.5 g from the port's own float32
    forward; its output bf16, its parameters float32 with the float32
    model's state_dict keys."""
    model = _port_model(tiny, {"model.dtype": "bfloat16"})
    assert list(model.state_dict()) == list(_port_model(tiny, {})
                                            .state_dict())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    _check_chained(_port_forward(model, tiny, False),
                   torch.from_numpy(jax_eval["p32"]), jax_eval["j16"])


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["eval", "train", "eval_fused"])
def test_bf16_model_matches_jax_compile_spread(tiny, mode):
    """The chained forward, also no further from JAX-bf16 than XLA's
    default compile of the same JAX program lands; in train mode (the
    spatial mask sent, LocalEnhancer on) and with the fused head too."""
    train = mode == "train"
    over = {"model.fused_upsample": True} if mode == "eval_fused" else {}
    args = [jnp.asarray(tiny[k]) for k in ("x", "c", "t", "ctx")]
    am = jnp.asarray(tiny["mask"]) if train else None
    jm = _jax_model({**over, "model.dtype": "bfloat16"})

    def fwd(p):
        return jm.apply({"params": p}, *args, attn_mask=am, train=train)

    j16 = _f32(_jit(fwd, tiny["params"]))
    spread = _rel(_f32(jax.jit(fwd)(tiny["params"])), j16)
    p16 = _port_forward(_port_model(tiny, {**over, "model.dtype":
                                           "bfloat16"}), tiny, train)
    p32 = _port_forward(_port_model(tiny, over), tiny, train)
    _check_chained(p16, p32, j16, spread)


def test_bf16_t_is_rounded_to_the_compute_type(tiny):
    """As in JAX, t/T is cast to bf16: neighbouring steps near T share one
    bf16 value, so the net cannot tell them apart (it can at fp32)."""
    steps = torch.arange(690, 700, dtype=torch.float32) / 700
    k = next(i for i in range(9)
             if steps[i].bfloat16() == steps[i + 1].bfloat16())
    t_a, t_b = float(steps[k]), float(steps[k + 1])
    for dt, same in (("bfloat16", True), ("float32", False)):
        model = _port_model(tiny, {"model.dtype": dt}).eval()
        x = torch.from_numpy(tiny["x"])
        c, ctx = torch.from_numpy(tiny["c"]), torch.ones(2)
        with torch.no_grad():
            a = model(x, c, torch.full((2,), t_a), ctx)
            b = model(x, c, torch.full((2,), t_b), ctx)
        assert torch.equal(a, b) == same


def test_bf16_eval_output_ignores_batch_position(tiny):
    """Without gradients each bf16 convolution runs one sample at a time
    (``kernels.per_sample_conv``): a sample's eval output is the same bit for
    bit wherever it sits in the batch (``SamplerService``'s pinned
    requests rely on it), with the kernels' twins and the fused head on."""
    model = _port_model(tiny, {"model.dtype": "bfloat16",
                               "model.use_pallas": True,
                               "model.fused_upsample": True}).eval()
    rng = np.random.RandomState(12)
    x = torch.from_numpy(rng.randn(4, 32, 32, 3).astype(np.float32))
    c, t = torch.tensor([0, 1, 2, 3]), torch.tensor([0.1, 0.5, 0.7, 0.9])
    ctx = torch.tensor([1.0, 0.0, 1.0, 0.0])
    perm = torch.tensor([2, 0, 3, 1])
    with torch.no_grad():
        base = model(x, c, t, ctx)
        moved = model(x[perm], c[perm], t[perm], ctx[perm])
    assert torch.equal(moved[torch.argsort(perm)], base)


# --- kernel twins -----------------------------------------------------------

def _ulp(y):
    """One bf16 ulp of |y| (8 significant bits)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(y), 1e-30))) - 7)


def _exact_gelu_kernels(monkeypatch):
    """The Pallas kernels with the exact-erf GELU of the port and the JAX
    modules (the TPU lowering lacked erf), traced afresh."""
    exact = lambda v: jax.nn.gelu(v, approximate=False)  # noqa: E731
    monkeypatch.setattr(jse, "_erf_gelu", exact)
    monkeypatch.setattr(jca, "_erf_gelu", exact)


@pytest.mark.parametrize("kernel", ["se_block", "coord_attn"])
def test_bf16_kernel_twin_matches_pallas_interpret(kernel, monkeypatch):
    """The bf16 twins (``se_block_plain`` / ``coord_attn_plain``, reached
    through the wrappers on CPU tensors) against the Pallas kernels in
    interpret mode on the same bf16 x: float32 pooling and MLP inside, SE's
    gate rounded to bf16, one rounding of the output. Elementwise within
    one bf16 ulp of |y|; a gate whose float32 value lands the other side of
    a bf16 rounding boundary moves its channel by one more ulp, allowed in
    at most 1% of the elements."""
    _exact_gelu_kernels(monkeypatch)
    rng = np.random.RandomState(5)
    b, l, c = 2, 16, 128
    x = jnp.asarray(rng.randn(b, l, l, c).astype(np.float32)).astype(
        jnp.bfloat16)
    tx = torch.from_numpy(_f32(x)).to(BF16)
    if kernel == "se_block":
        r = c // 16
        w1 = (rng.randn(c, r) / np.sqrt(c)).astype(np.float32)
        w2 = (rng.randn(r, c) / np.sqrt(r)).astype(np.float32)
        fn = jse.se_block_fused.__wrapped__
        want = jax.jit(lambda a: fn(a, jnp.asarray(w1), jnp.asarray(w2),
                                    interpret=True))(x)
        got = se_block(tx, torch.from_numpy(w1), torch.from_numpy(w2))
    else:
        torch.manual_seed(6)
        mod = CoordAttn(c, 16).eval()
        _randomize(mod, 7)
        sd = {f"ca.{k}": v.detach().numpy() for k, v in
              mod.state_dict().items()}
        m = _Mapper(sd)
        m.coord_attn(("ca",), "ca", "group")
        groups = jb.gn_groups(c // 16, 8)
        jw = jca.CoordAttnWeights(m.params["ca"], None, norm_kind="group")
        fn = jca.coord_attn_fused.__wrapped__
        want = jax.jit(lambda a: fn(a, jw, "group", groups,
                                    interpret=True))(x)
        with torch.no_grad():
            got = coord_attn(tx, CoordAttnWeights.from_module(mod), "group",
                             groups)
    assert want.dtype == jnp.bfloat16 and got.dtype == BF16
    want, got = _f32(want), got.float().numpy()
    diff = np.abs(got - want)
    assert np.all(diff <= 2 * _ulp(want) + 1e-30)
    assert np.mean(diff > _ulp(want)) <= 0.01
    assert np.mean(diff > 0) <= 0.05


def test_bf16_wrappers_keep_fp32_results_and_raise_for_other_types():
    """At float32 the twins give what they gave before the bf16 forms
    (``se_block`` equals the module's own path there), and the wrappers
    refuse float16."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(2, 8, 8, 64).astype(np.float32))
    w1 = torch.from_numpy(rng.randn(64, 4).astype(np.float32))
    w2 = torch.from_numpy(rng.randn(4, 64).astype(np.float32))
    torch.testing.assert_close(se_block(x, w1, w2),
                               tb.se_module_plain(x, w1, w2), rtol=0, atol=0)
    # in bf16 the kernel's function and the module's own path differ
    xb = x.to(BF16)
    assert not torch.equal(se_block(xb, w1, w2),
                           tb.se_module_plain(xb, w1, w2, BF16))


# --- training ---------------------------------------------------------------

def _draws(key, shape, dc):
    tkey, nkey, mkey = jax.random.split(key, 3)
    p = 1.0 - dc.drop_prob
    return dict(
        ts=np.array(jax.random.randint(tkey, (shape[0],), 1, dc.n_T + 1)),
        noise=np.array(jax.random.normal(nkey, shape, dtype=jnp.float32)),
        ctx_mask=np.array(jax.random.bernoulli(mkey, p, (shape[0],))
                          .astype(jnp.float32)))


@pytest.mark.slow
def test_bf16_train_loss_and_gradients_match_jax(tiny):
    """``train_loss`` and its gradients at bf16 against
    ``jax.value_and_grad`` of the JAX ``train_loss`` at bf16 and fp32, the
    JAX key's draws replayed: the loss (a mean, float32) within 0.5 g
    relative of JAX's bf16 loss, g the bf16 gap of the forward (the two
    losses' own gap is a mean of rounding errors of either sign, too small
    and too random a yardstick: 6e-4 here). The gradients (float32, as
    the parameters) over all leaves: no further from JAX's float32
    gradients than JAX's bf16 ones are (G, 0.17 here) and at least 0.5 G
    from them (bf16, not float32); measured 0.80 G. They are not held to
    JAX's bf16 gradients: the whole net's backward at bf16 carries
    rounding flips as the chained forward does, and both packages' bf16
    gradients sit about G from float32 and from each other."""
    cfg = preset("full", **TINY)
    dc = cfg.diffusion
    jsched = JSchedule.create(dc.beta1, dc.beta2, dc.n_T)
    x = np.clip(tiny["x"], -1, 1)
    c, mask = tiny["c"], np.where(tiny["mask"] > 1.2, 3.0, 0.5).astype(
        np.float32)
    key = jax.random.PRNGKey(11)
    res = {}
    for dt in ("float32", "bfloat16"):
        jm = _jax_model({"model.dtype": dt})

        def loss(p):
            def apply_fn(xt, cc, t, ctx, attn, train):
                return jm.apply({"params": p}, xt, cc, t, ctx,
                                attn_mask=attn, train=True)
            return jtrain_loss(apply_fn, key, jnp.asarray(x), jnp.asarray(c),
                               jnp.asarray(mask), jsched, jpreset(
                                   "full", **TINY).diffusion)

        lv, gr = _jit(jax.value_and_grad(loss), tiny["params"])
        res[dt] = (float(lv), state_dict_from_flax(
            jax.tree.map(lambda a: np.asarray(a, np.float32), gr)))
        res["eps" + dt[-2:]] = _f32(_jit(lambda p: jm.apply(
            {"params": p}, *[jnp.asarray(tiny[k]) for k in
                             ("x", "c", "t", "ctx")]), tiny["params"]))
    model = _port_model(tiny, {"model.dtype": "bfloat16"}).train()
    got = train_loss(model, torch.from_numpy(x), torch.from_numpy(c).long(),
                     torch.from_numpy(mask),
                     Schedule.create(dc.beta1, dc.beta2, dc.n_T, "cpu"), dc,
                     **_draws(key, x.shape, dc))
    got.backward()
    (l32, g32), (l16, g16) = res["float32"], res["bfloat16"]
    res["eps32"], res["eps16"] = res.pop("eps32"), res.pop("eps16")
    assert got.dtype == torch.float32
    g = _gap(res["eps16"], res["eps32"])
    assert abs(got.item() - l16) <= 0.5 * g * abs(l16)
    named = dict(model.named_parameters())
    flat = lambda d: np.concatenate([d[n].numpy().ravel()  # noqa: E731
                                     for n in sorted(named)])
    want16, want32 = flat(g16), flat(g32)
    port = np.concatenate([named[n].grad.numpy().ravel()
                           for n in sorted(named)])
    assert all(p.grad.dtype == torch.float32 for p in named.values())
    gap = _rel(want16, want32)
    assert gap > 1e-3
    err = _rel(port, want32)
    assert NOT_FP32_FACTOR * gap <= err <= gap, (err, gap)


def test_bf16_train_steps_keep_fp32_state(tiny):
    """Two bf16 train steps of 2 micro-batches without remat, then with
    each remat policy and both accumulator types: finite losses,
    parameters, Adam's nu and the EMA float32 (mu as
    ``train.moment_dtype`` says: bf16), and each remat policy the step
    without it, bit for bit (the float32 accumulator's)."""
    rng = np.random.RandomState(4)
    batch = {"x": rng.uniform(-1, 1, (2, 2, 32, 32, 3)).astype(np.float32),
             "c": np.array([[0, 1], [2, 3]], np.int32),
             "mask": rng.choice(np.float32([0.5, 1.0, 3.0]), (2, 2, 32, 32))}

    def run(remat, policy, acc):
        cfg = preset("full", **TINY, **{
            "model.dtype": "bfloat16", "train.remat": remat,
            "train.remat_policy": policy, "train.grad_accum_dtype": acc,
            "train.ema_decay": 0.999})
        dc = cfg.diffusion
        sched = Schedule.create(dc.beta1, dc.beta2, dc.n_T, "cpu")
        model = _port_model(tiny, {"model.dtype": "bfloat16"})
        state, opt = create_train_state(model, cfg, 1)
        step = make_train_step(model, sched, cfg, opt)
        losses = [step(state, batch, generator=torch.Generator()
                       .manual_seed(i)).item() for i in range(2)]
        assert all(np.isfinite(losses))
        assert all(p.dtype == torch.float32 for p in state.params)
        assert all(v.dtype == torch.float32 for v in state.opt_state.nu)
        assert all(m.dtype == torch.bfloat16 for m in state.opt_state.mu)
        assert all(p.dtype == torch.float32 for p in state.ema.parameters())
        return state, losses

    base, base_losses = run(False, "full", "float32")
    for policy, acc in (("full", "float32"), ("conv", "bfloat16"),
                        ("dots", "float32")):
        state, losses = run(True, policy, acc)
        if acc == "float32":
            assert losses == base_losses, policy
            for a, b in zip(state.params, base.params):
                assert torch.equal(a, b), policy


# --- sampling and checkpoints ----------------------------------------------

@pytest.mark.slow
def test_bf16_ddim_matches_jax_make_sampler(tiny):
    """A DDIM-5 trajectory of the bf16 port (``make_sampler``, casting at
    use) against the JAX package's ``make_sampler`` at bf16, which casts
    the parameters to bf16 once per call (its "precast"), from JAX's own
    start noise: nearer to it than JAX's fp32 sampler is, finite,
    float32."""
    n = 3
    res = {}
    key = jax.random.PRNGKey(2)
    for dt in ("float32", "bfloat16"):
        jcfg = jpreset("full", **TINY, **{"model.dtype": dt,
                                          "sample.sampler": "ddim",
                                          "sample.ddim_steps": 5})
        jm = jbuild_model(jcfg.model)
        jsched = JSchedule.create(jcfg.diffusion.beta1, jcfg.diffusion.beta2,
                                  jcfg.diffusion.n_T)
        sfn = jmake_sampler(jm, jcfg, jsched, False, n,
                            classes=jnp.arange(n) % 5)
        res[dt] = _f32(sfn.lower(tiny["params"], {}, key, 2.0).compile(
            compiler_options={"xla_allow_excess_precision": False})(
            tiny["params"], {}, key, 2.0))
    g = _gap(res["bfloat16"], res["float32"])
    x_init = np.asarray(jax.random.normal(jax.random.split(key)[1],
                                          (n, 32, 32, 3), jnp.float32))
    cfg = preset("full", **TINY, **{"model.dtype": "bfloat16",
                                    "sample.sampler": "ddim",
                                    "sample.ddim_steps": 5})
    dc = cfg.diffusion
    sched = Schedule.create(dc.beta1, dc.beta2, dc.n_T, "cpu")
    sampler = make_sampler(cfg, sched, n, classes=np.arange(n) % 5)
    got = sampler(_port_model(tiny, {"model.dtype": "bfloat16"}), None, 2.0,
                  x_init=x_init)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert _rel(got.numpy(), res["bfloat16"]) < g


def _crack_root(base):
    """Three classes of four 64 px JPEGs with VOC XML boxes (the layout of
    ``tests/test_torch_trainer.py``'s fixture)."""
    import xml.etree.ElementTree as ET

    from PIL import Image

    root = base / "cropped"
    (root / "annotations").mkdir(parents=True)
    rng = np.random.RandomState(0)
    for cls in ("a", "b", "c"):
        (root / "images" / cls).mkdir(parents=True)
        for i in range(4):
            stem = f"{cls}_{i}"
            Image.fromarray(rng.randint(0, 255, (64, 64, 3), np.uint8)).save(
                root / "images" / cls / f"{stem}.jpg")
            ann = ET.Element("annotation")
            sz = ET.SubElement(ann, "size")
            ET.SubElement(sz, "width").text = "64"
            ET.SubElement(sz, "height").text = "64"
            bb = ET.SubElement(ET.SubElement(ann, "object"), "bndbox")
            for k, v in zip(("xmin", "ymin", "xmax", "ymax"),
                            (10 + i, 20, 40, 50 - i)):
                ET.SubElement(bb, k).text = str(v)
            ET.ElementTree(ann).write(str(root / "annotations"
                                          / f"{stem}.xml"))
    return str(root)


def test_bf16_fit_checkpoint_loads_in_jax(tmp_path):
    """A bf16 ``fit`` with the fused upsample (the README's training
    settings) writes float32 parameters, EMA and Adam nu, which the JAX
    package's ``load_checkpoint`` reads, and which load back into a bf16
    port model bit for bit."""
    from diffusionmodel_tpu_torch.trainer import fit

    cfg = preset("full", **{
        **TINY, "model.n_classes": 3, "model.dtype": "bfloat16",
        "model.fused_upsample": True, "model.use_pallas": True,
        "train.n_epoch": 1, "train.batch_size": 2, "train.accum_steps": 2,
        "train.min_save_ep": 0, "train.val_split": 0.25,
        "train.eval_every": 1, "train.ema_decay": 0.9,
        "train.save_dir": str(tmp_path / "run"), "sample.sampler": "dpmpp",
        "sample.dpm_steps": 2, "sample.guide_scales": (2.0,),
        "sample.sample_dir": str(tmp_path / "samples"),
        "diffusion.n_T": 50}).replace(data_root=_crack_root(tmp_path))
    state = fit(cfg, device="cpu", verbose=False)
    assert state.model.dtype == BF16
    ck = jckpt.load_checkpoint(str(tmp_path / "run" / "ckpt_ep0"))
    for tree in (ck["params"], ck["ema_params"], ck["opt_state"]["nu"]):
        assert all(np.asarray(a).dtype == np.float32
                   for a in jax.tree.leaves(tree))
    again = copy.deepcopy(state.model)
    again.load_state_dict(state_dict_from_flax(ck["params"], {}))
    for (n, a), b in zip(state.model.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), n
