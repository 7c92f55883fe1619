"""The ranks of ``tests/test_torch_model_axis.py``: functions run in
spawned gloo processes through ``torch_parallel_ranks.spawn``.

Like ``torch_parallel_ranks`` this module imports only torch, numpy and
the port (never jax), so a spawned rank runs without JAX. Each function
takes ``(rank, world, init_file, out_dir, ...)``, starts its group, builds
its mesh over it and saves what the parent compares to
``out_dir/rank{rank}.pt``.
"""

import copy
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from torch_parallel_ranks import _metrics_losses, _save, tiny_model

LAYER_SEED = 5


def _group(rank, world, init):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)


def _mesh(data, model, spatial=1):
    from diffusionmodel_tpu_torch.parallel import make_mesh

    return make_mesh(data=data, model=model, spatial=spatial)


def _rel(a, b) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm())


# --------------------------------------------------- (a) the layer kinds
LAYER_KINDS = ("conv3x3", "conv4x4s2", "conv_transpose", "linear",
               "fused_head", "se_eval", "se_train", "coord_attn_eval",
               "coord_attn_train")


def layer_case(kind: str, dtype: torch.dtype):
    """(module, inputs) for one layer kind at 32 output channels, from
    torch seed ``LAYER_SEED`` (the same weights
    in either dtype); SE and CoordAttn run ``use_pallas`` (the kernels'
    twins on the CPU) in eval or train mode."""
    from diffusionmodel_tpu_torch.nn.blocks import (
        ConvTranspose2d,
        Linear,
        SEBlock,
        UnetUp,
        channels_last,
        conv,
    )
    from diffusionmodel_tpu_torch.nn.coord_attn import CoordAttn

    torch.manual_seed(LAYER_SEED)
    if kind == "conv3x3":
        mod, shapes = conv(16, 32, 3, dtype=dtype), [(2, 16, 8, 8)]
    elif kind == "conv4x4s2":
        mod, shapes = conv(16, 32, 4, stride=2, dtype=dtype), [(2, 16, 8, 8)]
    elif kind == "conv_transpose":
        mod = ConvTranspose2d(32, 32, 2, stride=2, compute_dtype=dtype)
        shapes = [(2, 32, 4, 4)]
    elif kind == "linear":
        mod, shapes = Linear(12, 32, compute_dtype=dtype), [(3, 12)]
    elif kind == "fused_head":
        mod = UnetUp(32, 32, dtype=dtype, fused_upsample=True)
        shapes = [(2, 16, 4, 4), (2, 16, 4, 4)]
    elif kind.startswith("se"):
        mod, shapes = SEBlock(32, 4, use_pallas=True, dtype=dtype), \
            [(2, 32, 8, 8)]
    else:
        mod = CoordAttn(32, 4, use_pallas=True, dtype=dtype)
        shapes = [(2, 32, 8, 8)]
    mod = mod.train() if kind.endswith("train") else mod.eval()
    rng = np.random.RandomState(11)
    inputs = []
    for s in shapes:
        x = torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dtype)
        inputs.append(channels_last(x) if x.dim() == 4 else x)
    return mod, inputs


class _Holder(torch.nn.Module):
    """A layer as submodule "0" (a model to cut), called with any
    number of inputs."""

    def __init__(self, mod):
        super().__init__()
        self.add_module("0", mod)

    def forward(self, *xs):
        return getattr(self, "0")(*xs)


def layer_vjp(mod, inputs, seed=13):
    """The output, the inputs' gradients and the parameters' gradients
    (by name) of ``sum(y * g)`` for a fixed random g."""
    xs = [x.detach().clone().requires_grad_(True) for x in inputs]
    y = mod(*xs)
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(seed))
    (y.float() * g).sum().backward()
    grads = {n: p.grad.detach().clone() for n, p in mod.named_parameters()
             if p.grad is not None}
    mod.zero_grad()
    return y.detach(), [x.grad.detach() for x in xs], grads


def layer_errors(mesh) -> dict:
    """{(kind, dtype): errors} of each layer kind cut over 'model' (every
    parameter of 32 output channels) against the same layer whole in this
    process: relative L2 of the output, of the inputs' gradients and of
    the parameters' gradients (this process's blocks, all leaves
    together); for bf16 also the whole layer's own bf16-vs-fp32 gaps,
    and every kind's count of cut parameters."""
    from diffusionmodel_tpu_torch.parallel.tensor import (
        attach_model_axis,
        model_shardings,
    )

    out = {}
    for kind in LAYER_KINDS:
        whole = {}
        for name, dt in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
            mod, inputs = layer_case(kind, dt)
            whole[name] = layer_vjp(mod, inputs)
            holder = _Holder(copy.deepcopy(mod))
            cut = attach_model_axis(holder, mesh, min_channels=32)
            y, gx, gp = layer_vjp(holder, inputs)
            wy, wgx, wgp = whole[name]
            cuts = model_shardings(holder)
            mine = torch.cat([g.reshape(-1).double() for g in gp.values()])
            want = torch.cat([
                (cuts[f"0.{n}"].local(g) if f"0.{n}" in cuts else g
                 ).reshape(-1).double() for n, g in wgp.items()])
            err = {"out": _rel(y, wy),
                   "x_grad": max(_rel(a, b) for a, b in zip(gx, wgx)),
                   "w_grad": _rel(mine, want), "cut": cut,
                   "same_leaves": sorted(gp) == sorted(f"0.{n}"
                                                       for n in wgp)}
            out[(kind, name)] = err
        y32, gx32, gp32 = whole["float32"]
        y16, gx16, gp16 = whole["bfloat16"]
        out[(kind, "bfloat16")]["gap"] = {
            "out": _rel(y16.float(), y32),
            "x_grad": max(_rel(a.float(), b) for a, b in zip(gx16, gx32)),
            "w_grad": _rel(torch.cat([g.reshape(-1) for g in gp16.values()]),
                           torch.cat([g.reshape(-1) for g in gp32.values()]))}
    return out


def pack_follows_blocks(mesh) -> dict:
    """An eval-mode CoordAttn (``use_pallas``: the kernel's twin on the
    CPU) cut over 'model', without gradients, so its packed weights are
    cached: after an in-place update of its ``conv_h`` block (what a step
    does) its output against a copy that packs anew, and against its
    output before the update."""
    from diffusionmodel_tpu_torch.parallel.tensor import attach_model_axis

    mod, (x,) = layer_case("coord_attn_eval", torch.float32)
    holder = _Holder(mod)
    attach_model_axis(holder, mesh, min_channels=32)
    with torch.no_grad():
        before = holder(x)
        mod.conv_h.weight.mul_(1.5)
        after = holder(x)
        mod.__dict__.pop("_packed_cache")
        fresh = holder(x)
    return {"equal_fresh": torch.equal(after, fresh),
            "moved": not torch.equal(after, before)}


def refuses_plain_layer(mesh) -> str:
    """The error ``attach_model_axis`` raises for a planned weight of a
    layer that cannot run on a block (PyTorch's own ``Conv2d``)."""
    from diffusionmodel_tpu_torch.parallel.tensor import attach_model_axis

    try:
        attach_model_axis(torch.nn.Sequential(torch.nn.Conv2d(4, 32, 1)),
                          mesh, min_channels=32)
    except TypeError as e:
        return str(e)
    return ""


# ------------------------------------ (b) the step, (d) sampler, service
def planned_leaves(model, mesh, min_channels) -> dict:
    """{name: (the planned dim, the whole shape)} of every leaf
    ``param_shardings`` cuts, for a model about to be cut."""
    from diffusionmodel_tpu_torch.parallel import param_shardings

    whole = dict(model.named_parameters())
    return {n: (sh.dims[0][0], whole[n].shape) for n, sh in
            param_shardings(mesh, model, min_channels).items()
            if not sh.is_replicated}


def train_steps(cfg, batches, draws, mesh, min_channels):
    """Two train steps of the tiny net (torch seed 0) cut over 'model'
    (``min_channels``) on ``batches`` (this process's block) with the
    global ``draws``: the losses, the whole parameters and EMA after the
    steps (gathered), whether each planned leaf holds half its rows, the
    moments' sizes against the blocks', and the gathered optimizer state
    (rank 0)."""
    from diffusionmodel_tpu_torch.diffusion import Schedule
    from diffusionmodel_tpu_torch.parallel import opt_state_shardings
    from diffusionmodel_tpu_torch.parallel.tensor import (
        attach_model_axis,
        full_state_dict,
    )
    from diffusionmodel_tpu_torch.train import (
        create_train_state,
        make_train_step,
        opt_state_to_host,
    )

    dc = cfg.diffusion
    model = tiny_model(cfg)
    plan = planned_leaves(model, mesh, min_channels)
    attach_model_axis(model, mesh, min_channels)
    held = dict(model.named_parameters())
    halves = all(
        held[n].shape[d] * 2 == shape[d]
        and all(held[n].shape[i] == s for i, s in enumerate(shape) if i != d)
        for n, (d, shape) in plan.items())
    state, opt = create_train_state(model, cfg, 1, mesh=mesh)
    step = make_train_step(model, Schedule.create(dc.beta1, dc.beta2,
                                                  dc.n_T, "cpu"),
                           cfg, opt, mesh=mesh)
    losses = [float(step(state, b, draws=d)) for b, d in zip(batches, draws)]
    n_data = mesh.shape["data"]
    zero1 = (opt_state_shardings(mesh, model) if cfg.train.zero1 else {})
    moments = all(
        m.numel() == v.numel() == p.numel() // (
            n_data if n in zero1 and not zero1[n].is_replicated else 1)
        for (n, p), m, v in zip(model.named_parameters(), state.opt_state.mu,
                                state.opt_state.nu))
    params = {n: t for n, t in full_state_dict(model).items()
              if n in held}
    ema = {n: t for n, t in full_state_dict(state.ema).items() if n in held}
    host = opt_state_to_host(model, state.opt_state)
    return {"losses": losses, "params": params, "ema": ema,
            "planned": len(plan), "halves": halves, "moments": moments,
            "held_numel": sum(p.numel() for p in held.values()),
            "opt_host": host}


def run_sampler(cfg, n_sample, mesh=None, seed=7):
    """``make_sampler`` of the tiny net (torch seed 0), guidance 2."""
    from diffusionmodel_tpu_torch.diffusion import Schedule
    from diffusionmodel_tpu_torch.trainer import make_sampler

    dc = cfg.diffusion
    sched = Schedule.create(dc.beta1, dc.beta2, dc.n_T, "cpu")
    sampler = make_sampler(cfg, sched, n_sample, mesh=mesh)
    return sampler(tiny_model(cfg), torch.Generator().manual_seed(seed), 2.0)


def service_requests(cfg, mesh=None):
    """A ``SamplerService`` of the tiny net (torch seed 0, max_batch 4,
    DDIM): a pinned request alone, then batched behind another. Rank 0
    returns the images; a follower returns None once rank 0 closes."""
    from diffusionmodel_tpu_torch.diffusion import Schedule
    from diffusionmodel_tpu_torch.serving import SamplerService

    dc = cfg.diffusion
    sched = Schedule.create(dc.beta1, dc.beta2, dc.n_T, "cpu")
    svc = SamplerService(tiny_model(cfg), cfg, sched, max_batch=4,
                         max_wait_ms=2000, service_seed=1, mesh=mesh)
    if mesh is not None and not mesh.is_main:
        svc.close()
        return None
    try:
        alone = svc.generate([1, 2], guide_w=2.0, seed=11)
        other = svc.submit([0, 1], guide_w=3.0, seed=5)
        pinned = svc.submit([1, 2], guide_w=2.0, seed=11)
        return {"alone": alone, "other": other.result(),
                "batched": pinned.result()}
    finally:
        svc.close()


def generate(cfg, ckpt, sample_dir):
    """``gen_samples`` of ``ckpt`` (2 per class, guidance 2, seed 3, no
    scoring) into ``sample_dir``: the images."""
    from diffusionmodel_tpu_torch.sample import gen_samples

    cfg = cfg.replace(sample=dataclasses.replace(
        cfg.sample, sample_dir=str(sample_dir)))
    out = gen_samples(cfg, ckpt, n_samples_per_class=2, guide_scales=[2.0],
                      eval_quality=False, seed=3, verbose=False,
                      device="cpu")
    return out[2.0]["images"]


def four_ranks(rank, world, init, out_dir, step_cfgs, batches, draws,
               min_channels, sampler_runs, service_cfg, gen_args):
    """Data 2 x model 2: the layer kinds (each data pair alike), the two
    train steps for each config in ``step_cfgs``, ``make_sampler`` for
    each run, ``SamplerService(mesh=)`` and ``gen_samples`` (its config's
    ``train.mesh_model`` 2)."""
    _group(rank, world, init)
    from diffusionmodel_tpu_torch.parallel import batch_sharding

    mesh = _mesh(2, 2)
    result = {"mesh": mesh.shape, "model_rank": mesh.rank("model"),
              "layers": layer_errors(mesh), "pack": pack_follows_blocks(mesh),
              "refused": refuses_plain_layer(mesh),
              "steps": {}, "samples": {}}
    rows = batch_sharding(mesh, 5, 1)
    local = [{k: rows.local(v) for k, v in b.items()} for b in batches]
    for name, cfg in step_cfgs.items():
        result["steps"][name] = train_steps(cfg, local, draws, mesh,
                                            min_channels)
    for name, cfg, n in sampler_runs:
        result["samples"][name] = run_sampler(cfg, n, mesh)
    result["service"] = service_requests(service_cfg, mesh)
    gen_cfg, ckpt, base = gen_args
    result["generate"] = generate(gen_cfg, ckpt,
                                  os.path.join(base, f"gen_rank{rank}"))
    _save(out_dir, rank, result)


# ----------------------------------------------------- (c) fit, 2 x 2 x 2
def fit_run(cfg, save_dir, resume=None):
    """``fit`` of the tiny net on 16 synthetic 32 px images into
    ``save_dir``: the final parameters, whole (gathered over 'model'),
    and the number of leaves this process holds a block of."""
    from diffusionmodel_tpu_torch.data import SyntheticImageDataset
    from diffusionmodel_tpu_torch.parallel.tensor import (
        full_state_dict,
        model_shardings,
    )
    from diffusionmodel_tpu_torch.trainer import fit

    cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                save_dir=str(save_dir)))
    state = fit(cfg, dataset=SyntheticImageDataset(n=16, img_size=32,
                                                   n_classes=2),
                verbose=False, resume=resume, device="cpu")
    names = {n for n, _ in state.model.named_parameters()}
    return ({n: t for n, t in full_state_dict(state.model).items()
             if n in names}, len(model_shardings(state.model)))


def one_fit(cfg, save_dir, resume=None):
    """``fit`` in one process (``train.mesh_*`` back to one)."""
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, mesh_data=-1, mesh_model=1, mesh_spatial=1))
    return fit_run(cfg, save_dir, resume)[0]


def fit_ranks(rank, world, init, out_dir, cfg, resume_cfg, base):
    """``fit`` on data 2 x model 2 x spatial 2 (each rank with its own
    save_dir, so a file written by another rank would show), then a
    resume from rank 0's checkpoint for one more epoch on the same
    mesh."""
    _group(rank, world, init)
    params, cut = fit_run(cfg, os.path.join(base, f"fit_rank{rank}"))
    ckpt = os.path.join(base, "fit_rank0", "ckpt_ep0")
    resumed, _ = fit_run(resume_cfg, os.path.join(base, f"resume_rank{rank}"),
                         resume=ckpt)
    result = {"params": params, "cut": cut, "resumed": resumed}
    if rank == 0:
        result["losses"] = _metrics_losses(os.path.join(base, "fit_rank0"), 0)
        result["resumed_losses"] = _metrics_losses(
            os.path.join(base, "resume_rank0"), 1)
    _save(out_dir, rank, result)
