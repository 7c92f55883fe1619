"""The JAX side of ``tests/test_torch_model_axis.py``: the JAX package's
train step on a data 2 x model 2 mesh, its parameters and EMA laid out by
``param_shardings`` (``min_channels`` 64, as the JAX package's own
``test_train_step_sharded_8dev``) and its moments replicated or
partitioned over 'data' (``train.zero1``), as ``fit`` lays them out.

It runs in a process of its own, beside the ranks, and imports no torch:
the tiny net's initial weights come from the parent as a pickle it waits
for. From ``tests/``,

    python -c "import conftest, jax_model_side as j; j.main('OUT_DIR')"

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
from diffusionmodel_tpu.parallel import param_shardings as jparam_shardings
from diffusionmodel_tpu.parallel import replicated as jreplicated
from diffusionmodel_tpu.train import TrainState as JTrainState
from diffusionmodel_tpu.train import build_optimizer as jbuild_optimizer
from diffusionmodel_tpu.train import make_train_step as jmake_train_step
from jax_parallel_side import STEP_OVER, STEP_SEEDS, TINY, wire_batch

DATA, MODEL = 2, 2
MIN_CHANNELS = 64


def mesh_steps(params) -> dict:
    """JAX's step on ``make_mesh(data=2, model=2)`` over the two batches,
    without and with ``train.zero1``: {layout: (losses, params, EMA)}.
    Both layouts share one trace of the step; each compiles."""
    jcfg = jpreset("full", **TINY, **STEP_OVER)
    dc = jcfg.diffusion
    tx = jbuild_optimizer(jcfg, 1)
    jp = jax.tree.map(jnp.asarray, params)
    init = JTrainState(step=jnp.zeros((), jnp.int32), params=jp,
                       batch_stats={}, opt_state=jax.jit(tx.init)(jp),
                       ema_params=jp)
    step = jmake_train_step(jbuild_model(jcfg.model, dc.high_thresh),
                            JSchedule.create(dc.beta1, dc.beta2, dc.n_T),
                            jcfg, tx, has_bn=False)
    mesh = jmake_mesh(data=DATA, model=MODEL,
                      devices=jax.devices()[:DATA * MODEL])
    rep = jreplicated(mesh)
    p_shard = jparam_shardings(mesh, jp, min_channels=MIN_CHANNELS)
    bshard = {"x": jbatch_sharding(mesh, 5, 1),
              "c": jbatch_sharding(mesh, 2, 1),
              "mask": jbatch_sharding(mesh, 4, 1)}
    opt_shard = {"rep": jax.tree.map(lambda _: rep, init.opt_state),
                 "zero1": jopt_shardings(mesh, init.opt_state)}
    out = {}
    for layout, opt in opt_shard.items():
        shard = init.replace(step=rep, params=p_shard, opt_state=opt,
                             ema_params=p_shard)
        jstep = jax.jit(step, in_shardings=(shard, bshard, rep),
                        out_shardings=(shard, rep))
        state = jax.device_put(init, shard)
        losses = []
        with mesh:
            for i, seed in enumerate(STEP_SEEDS):
                state, loss = jstep(state, jax.tree.map(jnp.asarray,
                                                        wire_batch(i)),
                                    jax.random.PRNGKey(seed))
                losses.append(float(loss))
        out[layout] = (losses, jax.tree.map(np.asarray, state.params),
                       jax.tree.map(np.asarray, state.ema_params))
    return out


def main(out_dir):
    path = os.path.join(out_dir, "jax_in.pkl")
    t_end = time.monotonic() + 300
    while not os.path.exists(path):
        if time.monotonic() > t_end:
            raise TimeoutError(f"no {path}")
        time.sleep(0.05)
    with open(path, "rb") as f:
        params = pickle.load(f)
    result = {"step": mesh_steps(params)}
    with open(os.path.join(out_dir, "jax_side.tmp"), "wb") as f:
        pickle.dump(result, f)
    os.replace(os.path.join(out_dir, "jax_side.tmp"),
               os.path.join(out_dir, "jax_side.pkl"))
