"""The JAX side of ``tests/test_torch_spatial.py``: the JAX package's
spatially sharded forward (GSPMD under ``image_sharding``) and its mesh
train step with H-slab batches, on the weights and inputs that file holds
the port's gloo ranks to.

It runs in a process of its own, beside the ranks, and imports no torch:
the weights come from the parent as a pickle it waits for. From
``tests/``,

    python -c "import conftest, jax_spatial_side as j; j.main('OUT_DIR')"

(``conftest`` sets up the 8 virtual CPU devices) reads
``OUT_DIR/jax_in.pkl`` and writes ``OUT_DIR/jax_side.pkl``.
"""

import os
import pickle
import time

import numpy as np

import jax
import jax.numpy as jnp

from diffusionmodel_tpu.config import preset as jpreset
from diffusionmodel_tpu.diffusion import Schedule as JSchedule
from diffusionmodel_tpu.nn import build_model as jbuild_model
from diffusionmodel_tpu.parallel import batch_sharding as jbatch_sharding
from diffusionmodel_tpu.parallel import image_sharding as jimage_sharding
from diffusionmodel_tpu.parallel import make_mesh as jmake_mesh
from diffusionmodel_tpu.parallel import replicated as jreplicated
from diffusionmodel_tpu.train import TrainState as JTrainState
from diffusionmodel_tpu.train import build_optimizer as jbuild_optimizer
from diffusionmodel_tpu.train import make_train_step as jmake_train_step

# (name, n_feat, img_size, spatial, data): the forward's cases. At 32 px
# over 4 slabs the stem and the last up stage run on slabs (8 rows) and
# the rest is gathered, the stride-2 downsample halo runs on 8-row slabs;
# at 64 px over 2 slabs three down and two up stages run on slabs, the
# upsample and its halo among them.
FORWARDS = [("32px_s4_d1", 16, 32, 4, 1), ("64px_s2_d2", 16, 64, 2, 2),
            ("64px_s2_d1", 16, 64, 2, 1)]
FWD_BATCH = 2
# the train step: data 2 x spatial 2, as PR 14's data-parallel step test
TINY = {"model.n_feat": 16, "model.img_size": 32, "model.n_classes": 3}
A, B = 2, 4  # micro-batches, global micro-batch
STEP_DATA, STEP_SPATIAL = 2, 2
LR = 1e-4
STEP_OVER = {"train.accum_steps": A, "train.batch_size": B,
             "train.ema_decay": 0.99, "train.lr": LR, "train.remat": False}
STEP_SEEDS = (50, 51)


def forward_input(img: int):
    """x [FWD_BATCH, img, img, 3], classes, t, context mask and a spatial
    mask (values over the LocalEnhancer's threshold in places)."""
    rng = np.random.RandomState(img)
    return (rng.randn(FWD_BATCH, img, img, 3).astype(np.float32),
            np.array([0, 2], np.int32), np.array([0.3, 0.7], np.float32),
            np.array([1.0, 0.0], np.float32),
            (rng.rand(FWD_BATCH, img, img) * 2).astype(np.float32))


def wire_batch(seed):
    """A global [A, B] batch in the uint8 wire format."""
    rng = np.random.RandomState(seed)
    return {"x": rng.randint(0, 256, (A, B, 32, 32, 3)).astype(np.uint8),
            "c": rng.randint(0, 3, (A, B)).astype(np.int32),
            "mask": rng.randint(0, 3, (A, B, 32, 32)).astype(np.uint8)}


def forwards(params: dict) -> dict:
    """{case: the GSPMD forward's output} (eval mode, with the mask)."""
    out = {}
    for name, nf, img, spatial, data in FORWARDS:
        cfg = jpreset("full", **{"model.n_feat": nf, "model.img_size": img,
                                 "model.n_classes": 3})
        model = jbuild_model(cfg.model, cfg.diffusion.high_thresh,
                             spatial_shards=spatial)
        mesh = jmake_mesh(data=data, model=1, spatial=spatial,
                          devices=jax.devices()[:data * spatial])
        x, c, t, ctx, mask = (jnp.asarray(a) for a in forward_input(img))
        v = {"params": jax.tree.map(jnp.asarray, params[name])}

        def fwd(v, x, mask):
            return model.apply(v, x, c, t, ctx, attn_mask=mask, train=False)

        with mesh:
            xsh = jimage_sharding(mesh, 4)
            msh = jimage_sharding(mesh, 3)
            got = jax.jit(fwd, in_shardings=(None, xsh, msh),
                          out_shardings=xsh)(
                v, jax.device_put(x, xsh), jax.device_put(mask, msh))
        out[name] = np.asarray(got)
    return out


def step_draws(key, dc):
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


def mesh_steps(params) -> tuple:
    """JAX's train step on a data 2 x spatial 2 mesh with the batch laid
    out as ``fit`` lays it out with ``train.mesh_spatial`` (H over
    'spatial'), over two wire batches: (losses, params)."""
    jcfg = jpreset("full", **TINY, **STEP_OVER)
    dc = jcfg.diffusion
    tx = jbuild_optimizer(jcfg, 1)
    jp = jax.tree.map(jnp.asarray, params)
    init = JTrainState(step=jnp.zeros((), jnp.int32), params=jp,
                       batch_stats={}, opt_state=jax.jit(tx.init)(jp),
                       ema_params=jp)
    step = jmake_train_step(
        jbuild_model(jcfg.model, dc.high_thresh, spatial_shards=STEP_SPATIAL),
        JSchedule.create(dc.beta1, dc.beta2, dc.n_T), jcfg, tx, has_bn=False)
    mesh = jmake_mesh(data=STEP_DATA, model=1, spatial=STEP_SPATIAL,
                      devices=jax.devices()[:STEP_DATA * STEP_SPATIAL])
    rep = jreplicated(mesh)
    bshard = {"x": jimage_sharding(mesh, 5, batch_axis=1, h_axis=2),
              "c": jbatch_sharding(mesh, 2, 1),
              "mask": jimage_sharding(mesh, 4, batch_axis=1, h_axis=2)}
    shard = init.replace(step=rep, params=jax.tree.map(lambda _: rep, jp),
                         opt_state=jax.tree.map(lambda _: rep,
                                                init.opt_state),
                         ema_params=jax.tree.map(lambda _: rep, jp))
    state = jax.device_put(init, shard)
    losses = []
    with mesh:
        jstep = jax.jit(step, in_shardings=(shard, bshard, rep),
                        out_shardings=(shard, rep))
        for i, seed in enumerate(STEP_SEEDS):
            state, loss = jstep(state, jax.tree.map(jnp.asarray,
                                                    wire_batch(i)),
                                jax.random.PRNGKey(seed))
            losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, state.params)


def main(out_dir):
    path = os.path.join(out_dir, "jax_in.pkl")
    t_end = time.monotonic() + 300
    while not os.path.exists(path):
        if time.monotonic() > t_end:
            raise TimeoutError(f"no {path}")
        time.sleep(0.05)
    with open(path, "rb") as f:
        given = pickle.load(f)
    result = {"forward": forwards(given["forward"]),
              "step": mesh_steps(given["step"])}
    with open(os.path.join(out_dir, "jax_side.tmp"), "wb") as f:
        pickle.dump(result, f)
    os.replace(os.path.join(out_dir, "jax_side.tmp"),
               os.path.join(out_dir, "jax_side.pkl"))
