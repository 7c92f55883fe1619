"""The JAX side of ``tests/test_torch_parallel.py``: the JAX package's
spatial helpers and its mesh train step on the inputs that file holds the
port's gloo ranks to.

It runs in a process of its own, beside the ranks, and is the file's
longest path (tracing the step once, compiling it for two layouts), so it
imports no torch and makes what it can itself; only the tiny net's
initial weights come from the parent, as a pickle it waits for. From
``tests/``,

    python -c "import conftest, jax_parallel_side as j; j.main('OUT_DIR')"

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
from diffusionmodel_tpu.parallel import make_mesh as jmake_mesh
from diffusionmodel_tpu.parallel import opt_state_shardings as jopt_shardings
from diffusionmodel_tpu.parallel import replicated as jreplicated
from diffusionmodel_tpu.parallel import spatial as jspatial
from diffusionmodel_tpu.train import TrainState as JTrainState
from diffusionmodel_tpu.train import build_optimizer as jbuild_optimizer
from diffusionmodel_tpu.train import make_train_step as jmake_train_step

TINY = {"model.n_feat": 16, "model.img_size": 32, "model.n_classes": 3}
A, B, RANKS = 2, 4, 4  # micro-batches, global micro-batch, train ranks
LR = 1e-4
STEP_OVER = {"train.accum_steps": A, "train.batch_size": B,
             "train.ema_decay": 0.99, "train.lr": LR, "train.remat": False}
STEP_SEEDS = (40, 41)  # the JAX step's key for each of the two steps


def wire_batch(seed):
    """A global [A, B] batch in the uint8 wire format."""
    rng = np.random.RandomState(seed)
    return {"x": rng.randint(0, 256, (A, B, 32, 32, 3)).astype(np.uint8),
            "c": rng.randint(0, 3, (A, B)).astype(np.int32),
            "mask": rng.randint(0, 3, (A, B, 32, 32)).astype(np.uint8)}


def spatial_input():
    """The JAX package's ``test_spatial_sharding_pools`` input (2,32,16,8)
    and the SE weights."""
    x = jax.random.normal(jax.random.PRNGKey(0), (2, 32, 16, 8))
    w1 = jax.random.normal(jax.random.PRNGKey(1), (8, 4)) * 0.1
    w2 = jax.random.normal(jax.random.PRNGKey(2), (4, 8)) * 0.1
    return x, w1, w2


def mesh_steps(params):
    """JAX's train step on ``make_mesh(data=4)`` over the two batches,
    laid out as ``fit`` lays it out without and with ``train.zero1``:
    {layout: (losses, params)}. Both layouts share one trace of the step
    (the state is placed on the mesh first, as ``fit`` places it); each
    compiles."""
    jcfg = jpreset("full", **TINY, **STEP_OVER)
    dc = jcfg.diffusion
    tx = jbuild_optimizer(jcfg, 1)
    jp = jax.tree.map(jnp.asarray, params)
    # one jitted init: eager zeros would compile once per leaf
    init = JTrainState(step=jnp.zeros((), jnp.int32), params=jp,
                       batch_stats={}, opt_state=jax.jit(tx.init)(jp),
                       ema_params=jp)
    step = jmake_train_step(jbuild_model(jcfg.model, dc.high_thresh),
                            JSchedule.create(dc.beta1, dc.beta2, dc.n_T),
                            jcfg, tx, has_bn=False)
    mesh = jmake_mesh(data=RANKS, model=1)
    rep = jreplicated(mesh)
    bshard = {"x": jbatch_sharding(mesh, 5, 1),
              "c": jbatch_sharding(mesh, 2, 1),
              "mask": jbatch_sharding(mesh, 4, 1)}
    opt_shard = {"rep": jax.tree.map(lambda _: rep, init.opt_state),
                 "zero1": jopt_shardings(mesh, init.opt_state)}
    batches = [wire_batch(0), wire_batch(1)]
    out = {}
    for layout, opt in opt_shard.items():
        shard = init.replace(step=rep, params=jax.tree.map(lambda _: rep, jp),
                             opt_state=opt,
                             ema_params=jax.tree.map(lambda _: rep, jp))
        jstep = jax.jit(step, in_shardings=(shard, bshard, rep),
                        out_shardings=(shard, rep))
        state = jax.device_put(init, shard)
        losses = []
        with mesh:
            for b, seed in zip(batches, STEP_SEEDS):
                state, loss = jstep(state, jax.tree.map(jnp.asarray, b),
                                    jax.random.PRNGKey(seed))
                losses.append(float(loss))
        out[layout] = (losses, jax.tree.map(np.asarray, state.params))
    return out


def main(out_dir):
    x, w1, w2 = spatial_input()
    jmesh = jmake_mesh(data=RANKS, model=1)
    result = {"spatial": {
        "mean": np.asarray(jspatial.sharded_global_mean(jmesh, x)),
        "se": np.asarray(jspatial.sharded_se_block(jmesh, x, w1, w2)),
        "pools": tuple(np.asarray(a) for a in
                       jspatial.sharded_directional_pools(jmesh, x))}}
    path = os.path.join(out_dir, "jax_in.pkl")
    t_end = time.monotonic() + 300
    while not os.path.exists(path):
        if time.monotonic() > t_end:
            raise TimeoutError(f"no {path}")
        time.sleep(0.1)
    with open(path, "rb") as f:
        result["step"] = mesh_steps(pickle.load(f))
    with open(os.path.join(out_dir, "jax_side.pkl"), "wb") as f:
        pickle.dump(result, f)
