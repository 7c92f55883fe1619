"""The ranks of ``tests/test_torch_parallel.py``: functions run in spawned
gloo processes (``torch.multiprocessing``, ``init_method=file://``).

This module imports only torch, numpy and the port (never jax), so a
spawned rank, which imports it to find its function, runs without JAX.
Each function takes ``(rank, world, init_file, out_dir, ...)``, starts
its group, runs its checks' port side and saves what the parent compares
to ``out_dir/rank{rank}.pt``.
"""

import dataclasses
import os

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def spawn(fn, world: int, tmp_path, *args):
    """Start ``fn(rank, world, init, out_dir, *args)`` on ``world`` gloo
    ranks; returns the context and output dir for :func:`join`. The
    arguments travel in a file: a spawn payload larger than a pipe's
    buffer would hold this process until each rank has imported torch."""
    out = tmp_path / f"{fn.__name__}_out"
    out.mkdir()
    torch.save(args, out / "args.pt")
    init = f"file://{tmp_path / (fn.__name__ + '_store')}"
    ctx = mp.start_processes(_run, args=(fn, world, init, str(out)),
                             nprocs=world, join=False, start_method="spawn")
    return ctx, out


def _run(rank, fn, world, init, out):
    fn(rank, world, init, out,
       *torch.load(os.path.join(out, "args.pt"), weights_only=False))


def join(ctx, out, world: int, timeout: float = 240.0):
    """Wait for every rank (raising a rank's error) and load their
    results, in rank order."""
    import time

    t_end = time.monotonic() + timeout
    while not ctx.join(timeout=max(t_end - time.monotonic(), 0.1)):
        if time.monotonic() > t_end:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError("ranks still running")
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _start(rank, world, init):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    from diffusionmodel_tpu_torch.parallel import make_mesh

    return make_mesh()


def _save(out_dir, rank, result):
    dist.destroy_process_group()
    result["jax_imported"] = "jax" in __import__("sys").modules
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


def tiny_model(cfg, seed=0):
    from diffusionmodel_tpu_torch.nn import build_model

    torch.manual_seed(seed)
    return build_model(cfg.model, cfg.diffusion.high_thresh, device="cpu")


def train_steps(cfg, batches, draws, mesh=None, seed=0):
    """The port's ``make_train_step`` from the seed's weights over
    ``batches`` (global, or this rank's block under ``mesh``) with the
    global ``draws``: the losses, the parameters, the moment blocks'
    sizes and the state."""
    from diffusionmodel_tpu_torch.diffusion import Schedule
    from diffusionmodel_tpu_torch.train import (
        create_train_state,
        make_train_step,
    )

    dc = cfg.diffusion
    model = tiny_model(cfg, seed)
    state, opt = create_train_state(model, cfg, 1, mesh=mesh)
    step = make_train_step(model, Schedule.create(dc.beta1, dc.beta2,
                                                  dc.n_T, "cpu"),
                           cfg, opt, mesh=mesh)
    losses, first = [], None
    for b, d in zip(batches, draws):
        losses.append(float(step(state, b, draws=d)))
        if first is None:
            first = {n: p.detach().clone()
                     for n, p in model.named_parameters()}
    return {"losses": losses, "first": first,
            "params": {n: p.detach().clone()
                       for n, p in model.named_parameters()},
            "moment_numel": [(m.numel(), v.numel())
                             for m, v in zip(state.opt_state.mu,
                                             state.opt_state.nu)],
            "state": state}


def train_step_ranks(rank, world, init, out_dir, spatial_in, cfgs, batches,
                     draws):
    """Spatial helpers on H-slabs, then the train step over 'data' for
    each config in ``cfgs`` (replicated and ZeRO-1)."""
    mesh = _start(rank, world, init)
    from diffusionmodel_tpu_torch.parallel import batch_sharding
    from diffusionmodel_tpu_torch.parallel.spatial import (
        sharded_directional_pools,
        sharded_global_mean,
        sharded_se_block,
    )
    from diffusionmodel_tpu_torch.train import opt_state_to_host

    x, w1, w2 = (torch.from_numpy(a) for a in spatial_in)
    # this rank's H-slab over 'data' (the helpers' default axis)
    mine = batch_sharding(mesh, 4, 1).local(x)
    x_h, x_w = sharded_directional_pools(mesh, mine)
    result = {"mean": sharded_global_mean(mesh, mine),
              "se": sharded_se_block(mesh, mine, w1, w2),
              "x_h": x_h, "x_w": x_w, "steps": {}}
    rows = batch_sharding(mesh, 5, 1)  # B of every [A, B, ...] array
    local = [{k: rows.local(v) for k, v in b.items()} for b in batches]
    for name, cfg in cfgs.items():
        run = train_steps(cfg, local, draws, mesh=mesh)
        host = opt_state_to_host(run["state"].model, run["state"].opt_state)
        result["steps"][name] = {
            "losses": run["losses"], "params": run["params"],
            "first": run["first"],
            "moment_numel": run["moment_numel"],
            "opt_host": None if host is None else {
                "mu": host["mu"], "nu": host["nu"]}}
    _save(out_dir, rank, result)


def bn_net(which: str, cfg=None):
    """The BatchNorm nets: ``"block"``, conv -> BatchNorm -> GELU -> conv
    -> BatchNorm of the port's layers (NCHW input); ``"net"``, the tiny
    net of ``cfg`` (``norm="batch"``)."""
    if which == "net":
        return tiny_model(cfg)
    from diffusionmodel_tpu_torch.nn.blocks import GELU, BatchNorm2d, Conv2d

    torch.manual_seed(0)
    return torch.nn.Sequential(Conv2d(3, 8, 3, padding=1), BatchNorm2d(8),
                               GELU(), Conv2d(8, 8, 3, padding=1),
                               BatchNorm2d(8))


def bn_forward_backward(which, cfg, inputs, mesh=None):
    """A train-mode forward and backward of :func:`bn_net` on ``inputs``
    (this rank's block under ``mesh``, with the global batch's
    statistics): the output, the gradients (averaged over the ranks, as
    the train step averages them) and the running statistics."""
    from diffusionmodel_tpu_torch.nn.blocks import global_batch_stats
    from diffusionmodel_tpu_torch.parallel import all_reduce_mean_

    model = bn_net(which, cfg).train()
    args = [torch.as_tensor(a) for a in inputs]
    with global_batch_stats(model, mesh.group("data") if mesh else None):
        out = model(*args)
        (out ** 2).mean().backward()
    grads = {n: p.grad if mesh is None else all_reduce_mean_(mesh, p.grad)
             for n, p in model.named_parameters()}
    stats = {n: b.clone() for n, b in model.named_buffers()
             if "running" in n}
    return out.detach(), grads, stats


def run_sampler(cfg, n_sample, seed, mesh=None):
    from diffusionmodel_tpu_torch.diffusion import Schedule
    from diffusionmodel_tpu_torch.models.annotated_ddpm.diffusion import (
        textbook_schedule,
    )
    from diffusionmodel_tpu_torch.trainer import make_sampler

    dc = cfg.diffusion
    sched = (textbook_schedule(dc.n_T, dc.beta1, dc.beta2, "cpu")
             if dc.schedule_family == "textbook"
             else Schedule.create(dc.beta1, dc.beta2, dc.n_T, "cpu"))
    sampler = make_sampler(cfg, sched, n_sample, mesh=mesh)
    return sampler(tiny_model(cfg), torch.Generator().manual_seed(seed), 2.0)


def bn_sampler_ranks(rank, world, init, out_dir, bn_cfg, bn_inputs,
                     sampler_runs):
    """BatchNorm over the global batch (``bn_inputs``: {net: inputs}),
    then ``make_sampler(mesh=)`` for each (name, cfg, n_sample)."""
    mesh = _start(rank, world, init)
    from diffusionmodel_tpu_torch.parallel import batch_sharding

    rows = batch_sharding(mesh, 4)
    result = {"bn": {}, "samples": {}}
    for which, inputs in bn_inputs.items():
        local = [rows.local(torch.as_tensor(a)) for a in inputs]
        out, grads, stats = bn_forward_backward(which, bn_cfg, local, mesh)
        result["bn"][which] = (rows.gather(out), grads, stats)
    for name, cfg, n in sampler_runs:
        result["samples"][name] = run_sampler(cfg, n, seed=7, mesh=mesh)
    _save(out_dir, rank, result)


def _metrics_losses(save_dir, epoch):
    import json

    with open(os.path.join(save_dir, "metrics",
                           f"metrics_ep{epoch}.json")) as f:
        log = json.load(f)
    return log["train_loss"] + log["val_loss"]


def fit_run(cfg, save_dir, resume=None):
    """``fit`` of the tiny net on 32 synthetic images into ``save_dir``:
    the final parameters."""
    from diffusionmodel_tpu_torch.data import SyntheticImageDataset
    from diffusionmodel_tpu_torch.trainer import fit

    cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                save_dir=str(save_dir)))
    state = fit(cfg, dataset=SyntheticImageDataset(n=32, img_size=32,
                                                   n_classes=2),
                verbose=False, resume=resume, device="cpu")
    return {n: p.detach().clone() for n, p in state.model.named_parameters()}


def fit_ranks(rank, world, init, out_dir, cfg, resume_cfg, base,
              one_process_ckpt):
    """``fit`` over 'data' (each rank with its own save_dir, so a file
    written by another rank would show), then the resumes: this group's
    checkpoint and the one-process run's, each for one more epoch."""
    mesh = _start(rank, world, init)
    mine = os.path.join(base, f"fit_rank{rank}")
    params = fit_run(cfg, mine)
    ckpt = os.path.join(base, "fit_rank0", "ckpt_ep0")
    resumed = {}
    for name, src in (("own", ckpt), ("one_process", one_process_ckpt)):
        d = os.path.join(base, f"resume_{name}_rank{rank}")
        resumed[name] = fit_run(resume_cfg, d, resume=src)
    result = {"params": params, "resumed": resumed,
              "mesh": mesh.shape}
    if rank == 0:
        result["losses"] = _metrics_losses(mine, 0)
        result["resumed_losses"] = {
            n: _metrics_losses(os.path.join(base, f"resume_{n}_rank0"), 1)
            for n in resumed}
    _save(out_dir, rank, result)
