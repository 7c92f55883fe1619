"""The ranks of ``tests/test_torch_spatial.py``: functions run in spawned
gloo processes through ``torch_parallel_ranks.spawn``.

Like ``torch_parallel_ranks`` this module imports only torch, numpy and
the port (never jax), so a spawned rank runs without JAX. Each function
takes ``(rank, world, init_file, out_dir, ...)``, starts its group, builds
the meshes it needs over it and saves what the parent compares to
``out_dir/rank{rank}.pt``.
"""

import contextlib
import dataclasses
import os

import torch
import torch.distributed as dist

from torch_parallel_ranks import _save, fit_run


def _group(rank, world, init):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)


def _mesh(data, spatial):
    from diffusionmodel_tpu_torch.parallel import make_mesh

    return make_mesh(data=data, model=1, spatial=spatial)


def context_unet(n_feat, img, spatial_shards=0, use_pallas=False):
    """The tiny flagship (3 classes) from torch seed 0's weights, with the
    spatial hooks for ``spatial_shards`` > 0."""
    from diffusionmodel_tpu_torch.config import preset
    from diffusionmodel_tpu_torch.nn import build_model

    cfg = preset("full", **{"model.n_feat": n_feat, "model.img_size": img,
                            "model.n_classes": 3,
                            "model.use_pallas": use_pallas})
    torch.manual_seed(0)
    return build_model(cfg.model, cfg.diffusion.high_thresh,
                       spatial_shards=spatial_shards, device="cpu").eval()


def train_steps(cfg, batches, draws, mesh=None):
    """The port's ``make_train_step`` from torch seed 0's weights (with the
    spatial hooks on a mesh) over ``batches`` (global, or this process's
    block) with the global ``draws``: the losses and the parameters."""
    from diffusionmodel_tpu_torch.diffusion import Schedule
    from diffusionmodel_tpu_torch.nn import build_model
    from diffusionmodel_tpu_torch.train import (
        create_train_state,
        make_train_step,
    )

    dc = cfg.diffusion
    torch.manual_seed(0)
    model = build_model(cfg.model, dc.high_thresh,
                        spatial_shards=mesh.shape["spatial"] if mesh else 0,
                        device="cpu")
    state, opt = create_train_state(model, cfg, 1, mesh=mesh)
    step = make_train_step(model, Schedule.create(dc.beta1, dc.beta2,
                                                  dc.n_T, "cpu"),
                           cfg, opt, mesh=mesh)
    losses = [float(step(state, b, draws=d)) for b, d in zip(batches, draws)]
    return {"losses": losses,
            "params": {n: p.detach().clone()
                       for n, p in model.named_parameters()}}


class _OneSlab:
    """A 'spatial' group of one process: sums over it are the identity."""

    shards = 1

    @staticmethod
    def all_reduce(x):
        return x


@contextlib.contextmanager
def float64_group_norm_stats(model):
    """Inside the block, ``model``'s GroupNorms take their statistics as
    they do on slabs (float64 sums of x and x^2, ``GroupNorm.
    _slab_forward``) on whole maps too, so that a one-process reference
    computes what the slabs compute up to summation order."""
    from diffusionmodel_tpu_torch.nn import blocks

    norms = [m for m in model.modules() if isinstance(m, blocks.GroupNorm)]
    before = blocks.is_slab
    blocks.is_slab = (lambda sp, x: sp is not None and (
        sp is _ONE or before(sp, x)))
    for m in norms:
        m.spatial = _ONE
    try:
        yield
    finally:
        blocks.is_slab = before
        for m in norms:
            m.spatial = None


_ONE = _OneSlab()


def forward(model, inputs, mesh=None):
    """The model's eval forward on ``inputs`` (x, c, t, ctx, mask: global
    numpy arrays); on a mesh through this process's H-slab of its block
    (``image_sharding``), the slabs gathered back."""
    from diffusionmodel_tpu_torch.parallel import (
        batch_sharding,
        image_sharding,
    )
    from diffusionmodel_tpu_torch.parallel.spatial import attach

    x, c, t, ctx, mask = (torch.as_tensor(a) for a in inputs)
    if mesh is None:
        with torch.no_grad():
            return model(x, c, t, ctx, mask)
    attach(model, mesh)
    img, rows = image_sharding(mesh, 4), image_sharding(mesh, 3)
    b = batch_sharding(mesh, 1)
    with torch.no_grad():
        y = model(img.local(x), b.local(c), b.local(t), b.local(ctx),
                  rows.local(mask))
    return img.gather(y.contiguous())


def halo_grads(sp_mesh=None, seed=3):
    """A 3x3 and a 4x4 stride-2 convolution (the port's layers) of a
    [2, 4, 16, 16] map: outputs, input gradients and weight gradients of
    ``sum(y * g)``; on a mesh through this process's slab (its rows of
    the input gradient, and the weight gradient summed over the slabs)."""
    from diffusionmodel_tpu_torch.nn.blocks import conv
    from diffusionmodel_tpu_torch.parallel.spatial import SpatialGroup

    out = {}
    for name, k, stride in (("3x3", 3, 1), ("4x4s2", 4, 2)):
        torch.manual_seed(seed)
        layer = conv(4, 4, k, stride=stride)
        gen = torch.Generator().manual_seed(seed)
        x = torch.randn(2, 4, 16, 16, generator=gen)
        g = torch.randn(2, 4, 16 // stride, 16 // stride, generator=gen)
        if sp_mesh is not None:
            sp = layer.spatial = SpatialGroup(sp_mesh)
            x, g = sp.take(x), sp.take(g)
        x = x.contiguous(memory_format=torch.channels_last).requires_grad_()
        y = layer(x)
        (y * g).sum().backward()
        wg = layer.weight.grad.clone()
        if sp_mesh is not None:
            dist.all_reduce(wg)
        out[name] = (y.detach(), x.grad, wg)
    return out


def spatial_ranks(rank, world, init, out_dir, fwd_cases, step_args,
                  sampler_runs, fit_args):
    """Four ranks: the halo exchange's backward (spatial 4), the forward
    cases that run on four ranks, the data 2 x spatial 2 train step, the
    samplers, then ``fit`` over data 2 x spatial 2."""
    _group(rank, world, init)
    result = {"forward": {}, "samples": {}}
    result["halo"] = halo_grads(_mesh(1, 4))
    for name, (nf, img, spatial, data, inputs) in fwd_cases.items():
        result["forward"][name] = forward(
            context_unet(nf, img, spatial), inputs, _mesh(data, spatial))
    cfg, batches, draws = step_args
    mesh = _mesh(2, 2)
    from diffusionmodel_tpu_torch.parallel import (
        batch_sharding,
        image_sharding,
    )

    img, cls = image_sharding(mesh, 5, 1, 2), batch_sharding(mesh, 2, 1)
    local = [{k: (cls if k == "c" else img).local(v) for k, v in b.items()}
             for b in batches]
    result["step"] = train_steps(cfg, local, draws, mesh=mesh)
    for name, cfg, n, (data, spatial) in sampler_runs:
        result["samples"][name] = run_sampler(cfg, n, _mesh(data, spatial))
    fit_cfg, base = fit_args
    result["fit"] = fit_run(fit_cfg, os.path.join(base, f"fit_rank{rank}"))
    _save(out_dir, rank, result)


def run_sampler(cfg, n_sample, mesh=None, seed=7):
    """``make_sampler`` of the tiny net with the spatial hooks (on a mesh)
    from torch seed 0's weights, guidance 2."""
    from diffusionmodel_tpu_torch.diffusion import Schedule
    from diffusionmodel_tpu_torch.nn import build_model
    from diffusionmodel_tpu_torch.trainer import make_sampler

    dc = cfg.diffusion
    sched = Schedule.create(dc.beta1, dc.beta2, dc.n_T, "cpu")
    torch.manual_seed(0)
    model = build_model(cfg.model, dc.high_thresh,
                        spatial_shards=mesh.shape["spatial"] if mesh else 0,
                        device="cpu")
    sampler = make_sampler(cfg, sched, n_sample, mesh=mesh)
    return sampler(model, torch.Generator().manual_seed(seed), 2.0)


def service_requests(cfg, mesh=None):
    """A ``SamplerService`` of the tiny net (torch seed 0, max_batch 4)
    over ``mesh``'s 'data' axis: a pinned request alone, then the same
    batched with another (its slots in the other rank's block). Rank 0
    returns the images; a follower returns None once rank 0 closes."""
    from diffusionmodel_tpu_torch.diffusion import Schedule
    from diffusionmodel_tpu_torch.nn import build_model
    from diffusionmodel_tpu_torch.serving import SamplerService

    dc = cfg.diffusion
    sched = Schedule.create(dc.beta1, dc.beta2, dc.n_T, "cpu")
    torch.manual_seed(0)
    model = build_model(cfg.model, dc.high_thresh, device="cpu")
    svc = SamplerService(model, cfg, sched, max_batch=4, max_wait_ms=2000,
                         service_seed=1, mesh=mesh)
    if mesh is not None and not mesh.is_main:
        svc.close()  # returns once rank 0 has closed the service
        return None
    try:
        alone = svc.generate([1, 2], guide_w=2.0, seed=11)
        other = svc.submit([0, 1], guide_w=3.0, seed=5)
        pinned = svc.submit([1, 2], guide_w=2.0, seed=11)
        return {"alone": alone, "other": other.result(),
                "batched": pinned.result(), "stats": dict(svc.stats)}
    finally:
        svc.close()


def pair_ranks(rank, world, init, out_dir, fwd_cases, service_cfg):
    """Two ranks: the forward cases that run on two (data 1 x spatial 2),
    then ``SamplerService(mesh=)`` over data 2."""
    _group(rank, world, init)
    result = {"forward": {}}
    for name, (nf, img, spatial, data, inputs) in fwd_cases.items():
        result["forward"][name] = forward(
            context_unet(nf, img, spatial), inputs, _mesh(data, spatial))
    result["service"] = service_requests(service_cfg, _mesh(2, 1))
    _save(out_dir, rank, result)


def fit_s3_ranks(rank, world, init, out_dir, fit_cfg, base):
    """Three ranks: ``fit`` over spatial 3 at a size that 3 does not
    divide, where the processes along 'spatial' hold whole images."""
    _group(rank, world, init)
    result = {"fit": fit_run(fit_cfg,
                             os.path.join(base, f"fit_s3_rank{rank}"))}
    _save(out_dir, rank, result)


def one_fit(cfg, save_dir):
    """``fit`` in one process (``train.mesh_*`` back to one)."""
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, mesh_data=-1, mesh_spatial=1))
    return fit_run(cfg, save_dir)

