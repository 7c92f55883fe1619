"""Training: state, optimizer, train/eval steps with gradient accumulation,
early stopping (counterpart of ``diffusionmodel_tpu/train.py``).

- **Optimizer.** ``optax.chain(clip_by_global_norm(grad_clip),
  adamw(schedule, weight_decay, mu_dtype))`` written out as plain
  functions over the parameter list (``torch._foreach_*``), op for op as
  optax computes it: the clip divides by the global norm with no ``+1e-6``
  (``clip_grad_norm_`` adds one); Adam's first moment is *stored* in
  ``train.moment_dtype`` (bfloat16 by default) while each update uses its
  float32 value before the cast (``b1``, rounded to that dtype, times the
  stored moment in float32: what XLA computes for optax under ``jit``);
  the weight decay is decoupled and scaled
  by the scheduled rate; the rate is read at the count before its
  increment. ``optimizer="adam"`` is the same without the decay.
- **In-place updates.** Parameters are updated on the ``Parameter``
  itself under ``no_grad`` (``torch._foreach_*_``), never through
  ``.data``: an in-place op bumps each tensor's version counter, which is
  what tells an eval-mode ``CoordAttn`` that its cached packed weights are
  stale (an update through ``.data`` would leave it sampling and
  validating with old weights, silently).
- **Steps.** ``make_train_step`` runs A micro-batches of an
  ``[A, B, ...]`` batch: gradients summed in ``train.grad_accum_dtype``,
  their float32 mean taken over A, then the clip and the update, then the
  EMA (warm-up ``min(decay, (1+step)/(10+step))`` at the step before its
  increment). BatchNorm statistics carry through the micro-batches in
  order. ``remat`` wraps the denoiser in ``torch.utils.checkpoint``
  (policies ``full``, ``conv``, ``dots``). The train-mode forward runs SE
  and CoordAttn through their differentiable twins, as the JAX package
  does; ``make_eval_step`` runs in eval mode, so with ``model.use_pallas``
  it takes the CUDA kernels.
- **Draws.** Each micro-batch's (t, eps, context mask) come from the
  step's ``torch.Generator`` or are handed in (``draws``), which is how
  the tests replay the JAX package's ``jax.random`` draws.
- **Data and spatial parallelism** (``mesh=``, ``parallel``): each
  process steps on its block of the batch with the global batch's draws,
  BatchNorm takes the global batch's statistics, and the gradients and
  the loss are averaged over 'data' once a step, before the clip; with
  ``train.zero1`` each process keeps, clips and updates only its block of
  the moments the ZeRO-1 rule partitions (``_reduce_and_update_``). When
  the mesh has a 'spatial' axis that divides the model's ``img_size`` and
  the model carries the spatial hooks (``build_model(spatial_shards=)``;
  ``parallel.spatial.runs_on_slabs``), the block is an H-slab of its
  samples (``image_sharding``), the loss is this slab's mean (equal slabs:
  their mean is the global mean), BatchNorm's statistics span data x
  spatial, and the gradients are summed over 'spatial' first; ZeRO-1
  stays over 'data'. On a 'model' axis (``parallel.tensor``: the model
  cut by ``attach_model_axis`` before ``create_train_state``) each
  process holds, updates and averages (over 'data' x 'spatial' only) its
  block of every planned leaf, with that leaf's moments and EMA; the
  clip's global norm counts each replicated leaf once and sums the
  blocks' squares over 'model' (and over 'data' under ZeRO-1, which
  partitions the block).

PyTorch updates the model and the optimizer state in place, so a step
returns only its loss (a float32 scalar tensor on the device).

With ``tracing`` on, a step records ``train.step``; per micro-batch
``train.feed`` (the copy to the device and the wire decode),
``train.fwd_bwd`` and ``train.accum``; then ``train.optimizer`` (the clip
and the update, with ``train.reduce`` inside it on a mesh) and
``train.ema``.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from diffusionmodel_tpu_torch import tracing
from diffusionmodel_tpu_torch.compat.flax_bridge import flax_from_state_dict
from diffusionmodel_tpu_torch.config import Config
from diffusionmodel_tpu_torch.diffusion import Schedule, loss_draws, train_loss
from diffusionmodel_tpu_torch.lr_schedules import build_schedule
from diffusionmodel_tpu_torch.nn.blocks import global_batch_stats
from diffusionmodel_tpu_torch.parallel.mesh import (
    Mesh,
    Sharding,
    all_reduce_mean_,
    batch_sharding,
    image_sharding,
    opt_state_shardings,
)
from diffusionmodel_tpu_torch.parallel.spatial import attach, is_slab
from diffusionmodel_tpu_torch.parallel.tensor import (
    full_state_dict,
    model_shardings,
)

_F32 = torch.float32
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# Adam's constants (optax.adam / adamw defaults).
B1, B2, EPS = 0.9, 0.999, 1e-8


# --------------------------------------------------------------- optimizer
class Optimizer(NamedTuple):
    """The optax chain's settings; its state is an :class:`OptState`."""

    schedule: Callable[[int], float]
    weight_decay: float  # 0.0 for optimizer="adam"
    grad_clip: float     # <= 0: no clipping
    mu_dtype: torch.dtype


@dataclasses.dataclass
class OptState:
    """Adam's state over the parameter list, in ``named_parameters`` order:
    ``count`` steps taken, ``mu`` in the moment dtype, ``nu`` in float32.
    Under ZeRO-1 ``shardings`` holds each moment's sharding
    (``parallel.opt_state_shardings``) and a partitioned moment is only
    this process's block of it; None: every moment whole."""

    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    shardings: Optional[List[Sharding]] = None


def build_optimizer(cfg: Config, steps_per_epoch: int) -> Optimizer:
    tc = cfg.train
    schedule = build_schedule(
        tc.lr_schedule, tc.lr, max(steps_per_epoch, 1), n_epoch=tc.n_epoch,
        t0=tc.sgdr_t0, t_mult=tc.sgdr_t_mult, eta_min=tc.sgdr_eta_min)
    if tc.optimizer == "adamw":
        wd = float(tc.weight_decay)
    elif tc.optimizer == "adam":
        wd = 0.0
    else:
        raise ValueError(f"unknown optimizer {tc.optimizer!r}")
    mu_dtype = torch.bfloat16 if tc.moment_dtype == "bfloat16" else _F32
    return Optimizer(schedule, wd, float(tc.grad_clip or 0.0), mu_dtype)


def init_opt_state(opt: Optimizer, params: Sequence[torch.Tensor],
                   shardings: Optional[Sequence[Sharding]] = None
                   ) -> OptState:
    """Zero moments, or with ``shardings`` (ZeRO-1) zero blocks of them."""
    if shardings is None or all(s.is_replicated for s in shardings):
        return OptState(
            count=0,
            mu=[torch.zeros_like(p, dtype=opt.mu_dtype) for p in params],
            nu=[torch.zeros_like(p, dtype=_F32) for p in params])
    blocks = [s.local(p.detach()) for s, p in zip(shardings, params)]
    return OptState(
        count=0,
        mu=[torch.zeros(b.shape, dtype=opt.mu_dtype, device=b.device)
            for b in blocks],
        nu=[torch.zeros(b.shape, dtype=_F32, device=b.device)
            for b in blocks],
        shardings=list(shardings))


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         norm: Optional[torch.Tensor] = None) -> None:
    """optax.clip_by_global_norm in place: unchanged below ``max_norm``,
    else ``(g / norm) * max_norm``, with no epsilon. Stays on the device
    (no host synchronisation). ``norm``: the global norm when ``grads``
    are blocks of it (ZeRO-1), else taken from ``grads``."""
    if norm is None:
        norm = global_norm(grads)
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))


@torch.no_grad()
def apply_updates_(opt: Optimizer, state: OptState,
                   params: List[torch.Tensor],
                   grads: List[torch.Tensor],
                   norm: Optional[torch.Tensor] = None) -> float:
    """One optimizer step in place on ``params`` and ``state``; ``grads``
    is consumed (overwritten). Returns the rate used. ``norm``: the
    global gradient norm for the clip when ``params`` / ``grads`` are
    ZeRO-1 blocks. Op for op:

        g   <- clip(g)
        nu  <- (1-b2) g^2 + b2 nu
        mu  <- (1-b1) g + b1 mu          (b1 rounded to mu's dtype)
        u   <- (mu / (1-b1^n)) / (sqrt(nu / (1-b2^n)) + eps) + wd p
        p   <- p + (-lr) u,   lr = schedule(n - 1),  mu stored cast."""
    if opt.grad_clip > 0:
        clip_by_global_norm_(grads, opt.grad_clip, norm)
    lr = opt.schedule(state.count)
    count = state.count + 1
    tmp = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(tmp, 1 - B2)
    torch._foreach_mul_(state.nu, B2)
    torch._foreach_add_(state.nu, tmp)
    del tmp
    torch._foreach_mul_(grads, 1 - B1)
    # b1 rounded to the moment dtype times the stored moment, the product
    # kept in float32: what XLA computes for optax under jit (excess
    # precision: the bfloat16 product is not rounded)
    b1_stored = float(torch.tensor(B1, dtype=opt.mu_dtype))
    mu = [m.float() for m in state.mu] if opt.mu_dtype != _F32 \
        else [m.clone() for m in state.mu]
    torch._foreach_mul_(mu, b1_stored)
    torch._foreach_add_(mu, grads)
    del grads[:]
    for stored, m in zip(state.mu, mu):
        stored.copy_(m)
    bc1 = float(1 - torch.tensor(B1, dtype=_F32) ** count)
    bc2 = float(1 - torch.tensor(B2, dtype=_F32) ** count)
    torch._foreach_div_(mu, bc1)
    denom = torch._foreach_div(state.nu, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, EPS)
    torch._foreach_div_(mu, denom)
    del denom
    if opt.weight_decay:
        torch._foreach_add_(mu, torch._foreach_mul(params, opt.weight_decay))
    torch._foreach_mul_(mu, float(torch.tensor(-lr, dtype=_F32)))
    torch._foreach_add_(params, mu)
    state.count = count
    return lr


# ------------------------------------------------------------------ state
@dataclasses.dataclass
class TrainState:
    """What training updates in place: the model (parameters and BatchNorm
    buffers), Adam's state over ``model.parameters()``, the optimizer
    ``step`` count of the loop, and the EMA shadow (a copy of the model
    whose parameters are the shadow; None when ``train.ema_decay`` is 0)."""

    step: int
    model: nn.Module
    opt_state: OptState
    ema: Optional[nn.Module] = None

    @property
    def params(self) -> List[nn.Parameter]:
        return list(self.model.parameters())

    def sampling_model(self) -> nn.Module:
        """The EMA shadow when kept (with the live BatchNorm statistics, as
        the JAX package samples ``ema_params`` with ``batch_stats``), else
        the live model; in eval mode."""
        if self.ema is None:
            return self.model.eval()
        with torch.no_grad():
            for mine, live in zip(self.ema.buffers(), self.model.buffers()):
                if not torch.equal(mine, live):
                    mine.copy_(live)
        return self.ema.eval()


def _ema_copy(model: nn.Module) -> nn.Module:
    ema = copy.deepcopy(model)
    for p in ema.parameters():
        p.requires_grad_(False)
    return ema.eval()


def create_train_state(model: nn.Module, cfg: Config, steps_per_epoch: int,
                       mesh: Optional[Mesh] = None) -> tuple:
    """(TrainState, Optimizer) over ``model`` as it is (the port's
    ``build_model`` draws the initial weights from the torch seed): on a
    'model' axis, the model already cut (its blocks are the leaves, and
    the EMA copy is cut alike). With ``train.zero1`` and a mesh, each
    process keeps only its block of the moments the ZeRO-1 rule
    partitions over 'data' (of the 'model' block, where there is one)."""
    opt = build_optimizer(cfg, steps_per_epoch)
    shardings = None
    if cfg.train.zero1 and mesh is not None:
        shardings = list(opt_state_shardings(mesh, model).values())
    state = TrainState(step=0, model=model,
                       opt_state=init_opt_state(opt, list(model.parameters()),
                                                shardings),
                       ema=_ema_copy(model) if cfg.train.ema_decay > 0
                       else None)
    return state, opt


def host_trees(model: nn.Module) -> tuple:
    """(params, batch_stats) of ``model`` as the JAX package's numpy trees
    (the walk of its arch, ``model.layout``), whole: a model cut over
    'model' gathers its blocks first (a collective: every process of the
    group calls it)."""
    return flax_from_state_dict(full_state_dict(model), **model.layout)


def opt_state_to_host(model: nn.Module, st: OptState) -> Dict:
    """The port's optimizer state as numpy copies: ``count`` and ``mu`` /
    ``nu`` by parameter name (``mu`` widened to float32, which is exact).
    ZeRO-1 blocks are gathered over 'data', then 'model' blocks over
    'model' (collectives: every process calls it, and only rank 0 gets
    the copies; the others get None), so the layout does not depend on
    the mesh."""
    names = [n for n, _ in model.named_parameters()]
    zero1 = st.shardings or [None] * len(names)
    cut = model_shardings(model)
    mu, nu = list(st.mu), list(st.nu)
    for i, (name, sh) in enumerate(zip(names, zero1)):
        for each in (sh, cut.get(name)):
            if each is not None:
                mu[i], nu[i] = each.gather(mu[i]), each.gather(nu[i])
    if (st.shardings or cut) and dist.get_rank() != 0:
        return None  # only rank 0 writes checkpoints

    def host(x):
        return x.detach().float().cpu().numpy().copy()

    return {"count": int(st.count),
            "mu": {n: host(m) for n, m in zip(names, mu)},
            "nu": {n: host(v) for n, v in zip(names, nu)}}


def opt_state_from_host(model: nn.Module, st: OptState, host) -> None:
    """Restore :func:`opt_state_to_host`'s layout in place, each moment
    cast to the dtype the run keeps it in (this process's block of it on
    the 'model' axis, then under ZeRO-1). Raises on any other layout (the
    JAX package's optax state)."""
    if not (isinstance(host, dict) and {"count", "mu", "nu"} <= set(host)
            and isinstance(host["mu"], dict)):
        raise ValueError(f"not the port's optimizer layout: "
                         f"{type(host).__name__}")
    names = [n for n, _ in model.named_parameters()]
    missing = [n for n in names if n not in host["mu"] or n not in host["nu"]]
    if missing:
        raise ValueError(f"optimizer state lacks {missing[:3]}")
    shardings = st.shardings or [None] * len(names)
    cut = model_shardings(model)

    def block(x, name, sh):
        x = np.asarray(x)
        for each in (cut.get(name), sh):
            if each is not None:
                x = each.local(x)
        return torch.from_numpy(np.ascontiguousarray(x))

    with torch.no_grad():
        for n, m, v, sh in zip(names, st.mu, st.nu, shardings):
            m.copy_(block(host["mu"][n], n, sh))
            v.copy_(block(host["nu"][n], n, sh))
    st.count = int(host["count"])


# ------------------------------------------------------------------- steps
def decode_wire(x: torch.Tensor, mask: Optional[torch.Tensor], dc,
                normalize: bool) -> tuple:
    """Expand the uint8 wire batch on the device: images ``/255`` then
    ``(x - .5) / .5`` (the same float32 ops as the host path, so
    bit-identical to it), mask class indices {0,1,2} to the config's
    [low, mid, high] weights. Float inputs pass through."""
    if x.dtype == torch.uint8:
        x = x.to(_F32) / 255.0
        if normalize:
            x = (x - 0.5) / 0.5
    if mask is not None and mask.dtype == torch.uint8:
        values = torch.tensor([dc.low_weight, dc.mid_weight, dc.high_weight],
                              dtype=_F32, device=mask.device)
        mask = values[mask.long()]
    return x, mask


_MATMULS = ("mm", "addmm", "bmm", "baddbmm", "matmul", "linear")
_CONVS = ("convolution", "conv2d", "cudnn_convolution",
          "convolution_overrideable")


def _sac_policy(saved: tuple):
    from torch.utils.checkpoint import CheckpointPolicy

    def policy(ctx, op, *args, **kwargs):
        name = getattr(op, "__name__", str(op)).split(".")[0]
        return (CheckpointPolicy.MUST_SAVE if name in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return policy


def remat_denoiser(model: nn.Module, remat: bool, policy: str = "full"
                   ) -> Callable:
    """The denoiser as called by the loss: ``model`` itself, or wrapped in
    ``torch.utils.checkpoint`` (non-reentrant). ``"full"`` recomputes the
    whole forward in the backward; ``"conv"`` saves convolution and matmul
    outputs and recomputes the rest (norms, activations, gates); ``"dots"``
    saves only matmul outputs. Any other policy is an error (the JAX
    package treats it as ``"full"``)."""
    if policy not in ("full", "conv", "dots"):
        raise ValueError(f"unknown train.remat_policy {policy!r} "
                         "(expected full | conv | dots)")
    if not remat:
        return model
    if policy == "full":
        context_fn = None
    else:
        from torch.utils.checkpoint import create_selective_checkpoint_contexts

        saved = _MATMULS + (_CONVS if policy == "conv" else ())
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       _sac_policy(saved))

    def net(*args):
        kw = {"use_reentrant": False}
        if context_fn is not None:
            kw["context_fn"] = context_fn
        return checkpoint(model, *args, **kw)

    return net


def _to(v, device) -> Optional[torch.Tensor]:
    if v is None:
        return None
    return torch.as_tensor(v).to(device, non_blocking=True)


@torch.no_grad()
def update_ema_(state: TrainState, decay: float) -> None:
    """``ema <- ema * d + p * (1 - d)`` with ``d = min(decay,
    (1+step)/(10+step))`` at the step before its increment, in float32."""
    s = torch.tensor(float(state.step), dtype=_F32)
    d = torch.minimum(torch.tensor(decay, dtype=_F32), (1.0 + s) / (10.0 + s))
    ema = list(state.ema.parameters())
    torch._foreach_mul_(ema, float(d))
    torch._foreach_add_(ema, torch._foreach_mul(state.params, float(1.0 - d)))


def _data_mesh(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """The mesh when it spans processes (a group was started), else None:
    one process runs the plain step."""
    if mesh is None or not mesh.distributed:
        return None
    return mesh


def _local_draws(mesh: Optional[Mesh], dc, x: torch.Tensor, generator,
                 given: Optional[Dict], spatial: bool = False) -> Dict:
    """``train_loss``'s draws for this process's block ``x`` of the batch
    (an H-slab of it with ``spatial``): as given, or drawn from
    ``generator``. Under a mesh they are drawn (or given) for the global
    batch, identically on every process, and each process takes its
    block: its samples' t and context mask, its samples' (and rows')
    noise."""
    if mesh is None:
        return given or {}
    n = mesh.shape["data"]
    h = x.shape[1] * (mesh.shape["spatial"] if spatial else 1)
    full = given or loss_draws(dc, (n * x.shape[0], h, *x.shape[2:]),
                               generator, x.device)
    noise = image_sharding(mesh, 4) if spatial else batch_sharding(mesh, 4)
    return {k: None if v is None else
            (noise if k == "noise" else batch_sharding(mesh, 1)).local(
                torch.as_tensor(v))
            for k, v in full.items()}


def _spatial_mean_(mesh: Mesh, tensors: List[torch.Tensor]) -> None:
    """Each tensor replaced in place by its mean over 'spatial' (one
    flattened all_reduce; nothing without a 'spatial' axis)."""
    s = mesh.shape["spatial"]
    if s == 1:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group("spatial"))
    flat.div_(s)
    for t, seg in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(seg.view(t.shape))


def _clip_norm(mesh: Mesh, grads: List[torch.Tensor], part: List[int],
               on_model: List[bool]) -> torch.Tensor:
    """optax.global_norm of gradients that are blocks: the squares of
    the ZeRO-1 blocks (``part``) summed over 'data', those of the 'model'
    blocks (``on_model``) over 'model', every other leaf counted once, as
    every process holds it whole. The same value on every process."""
    def sq(idx):
        ts = [grads[i] for i in idx]
        return (torch.stack(torch._foreach_norm(ts)).square().sum() if ts
                else grads[0].new_zeros(()))

    rep = [i for i in range(len(grads)) if i not in part]
    total = sq([i for i in part if not on_model[i]])
    if any(on_model):
        both = torch.stack([total, sq([i for i in part if on_model[i]])])
        if part:
            dist.all_reduce(both, group=mesh.group("data"))
        total, over_model = both[0], both[1]
        over_model = over_model + sq([i for i in rep if on_model[i]])
        dist.all_reduce(over_model, group=mesh.group("model"))
        total = total + over_model
    elif part:
        dist.all_reduce(total, group=mesh.group("data"))
    whole = [i for i in rep if not on_model[i]]
    if whole:
        total = total + sq(whole)
    return torch.sqrt(total)


def _model_mean_(mesh: Mesh, grads: List[torch.Tensor],
                 on_model: List[bool], loss: torch.Tensor) -> torch.Tensor:
    """The gradients of the leaves every 'model' process holds whole (or
    the same ZeRO-1 block of), and the loss, replaced by their mean over
    'model' (one flattened ``all_reduce``). The processes compute them
    from the same gathered maps, but a backward that is not deterministic
    (cuDNN's atomics) gives them other bits, and the replicas would drift
    apart; the mean of equal values is the value."""
    same = [i for i, m in enumerate(on_model) if not m]
    flat = torch.cat([grads[i].reshape(-1) for i in same] + [loss.reshape(1)])
    dist.all_reduce(flat, group=mesh.group("model"))
    flat.div_(mesh.shape["model"])
    for i, seg in zip(same, flat[:-1].split([grads[i].numel()
                                              for i in same])):
        grads[i].copy_(seg.view(grads[i].shape))
    return flat[-1]


@torch.no_grad()
def _reduce_and_update_(opt: Optimizer, state: TrainState, mesh: Mesh,
                        grads: List[torch.Tensor], loss: torch.Tensor
                        ) -> torch.Tensor:
    """The data-parallel half of the step: average the gradients and the
    loss over 'spatial' (where the mesh has it: each slab's gradient is
    its share), then over 'data', and update. Replicated leaves and the
    loss go through one flattened ``all_reduce``; under ZeRO-1 the
    partitioned
    leaves go through one ``reduce_scatter`` into this process's blocks,
    AdamW updates the blocks and one ``all_gather`` puts the new
    parameters back together. The groups are this process's 'data' and
    'spatial' ones: on a 'model' axis each process averages its blocks
    with the processes that hold the same ones, and the leaves they all
    hold alike are averaged over 'model' too (:func:`_model_mean_`). The
    clip takes the global norm (:func:`_clip_norm`). Returns the global
    mean loss."""
    group, n = mesh.group("data"), mesh.shape["data"]
    params = state.params
    cut = model_shardings(state.model)
    on_model = [name in cut for name, _ in state.model.named_parameters()]
    shardings = state.opt_state.shardings or [None] * len(params)
    part = [i for i, sh in enumerate(shardings)
            if sh is not None and not sh.is_replicated]
    rep = sorted(set(range(len(params))) - set(part))
    upd = list(params)
    with tracing.span("train.reduce"):
        loss = loss.reshape(1).clone()
        _spatial_mean_(mesh, grads + [loss])
        flat = torch.cat([grads[i].reshape(-1) for i in rep]
                         + [loss.reshape(1)])
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        for i, seg in zip(rep, flat[:-1].split([grads[i].numel()
                                                for i in rep])):
            grads[i].copy_(seg.view(grads[i].shape))
        loss = flat[-1]
        if part:
            dims = {i: shardings[i].dims[0][0] for i in part}
            rows = torch.cat([grads[i].movedim(dims[i], 0).reshape(n, -1)
                              for i in part], dim=1)
            blocks = torch.empty(rows.shape[1], dtype=rows.dtype,
                                 device=rows.device)
            dist.reduce_scatter_tensor(blocks, rows.reshape(-1), group=group)
            del rows
            blocks.div_(n)
            sizes = [params[i].numel() // n for i in part]
            for i, seg in zip(part, blocks.split(sizes)):
                moved = params[i].movedim(dims[i], 0).shape
                grads[i] = seg.view(moved[0] // n, *moved[1:]).movedim(
                    0, dims[i])
                upd[i] = shardings[i].local(params[i])
        if any(on_model):
            loss = _model_mean_(mesh, grads, on_model, loss)
    norm = None
    if opt.grad_clip > 0 and (part or any(on_model)):
        norm = _clip_norm(mesh, grads, part, on_model)
    apply_updates_(opt, state.opt_state, upd, grads, norm)
    if part:
        mine = torch.cat([upd[i].movedim(dims[i], 0).reshape(-1)
                          for i in part])
        every = torch.empty(n * mine.numel(), dtype=mine.dtype,
                            device=mine.device)
        dist.all_gather_into_tensor(every, mine, group=group)
        cols = every.view(n, -1).split(sizes, dim=1)
        for i, col in zip(part, cols):
            moved = params[i].movedim(dims[i], 0).shape
            params[i].copy_(col.reshape(moved).movedim(0, dims[i]))
    return loss


def make_train_step(model: nn.Module, sched: Schedule, cfg: Config,
                    opt: Optimizer, normalize_u8: bool = True,
                    mesh: Optional[Mesh] = None):
    """Returns ``step(state, batch, generator=None, draws=None) -> loss``.

    batch: ``x`` [A, B, H, W, C] (float, or the uint8 wire format), ``c``
    [A, B], ``mask`` [A, B, H, W] or None (float weights, or uint8 class
    indices); numpy arrays or tensors, moved to the model's device. A is
    the number of micro-batches. ``draws``: optionally A dicts of
    ``ts`` / ``noise`` / ``ctx_mask`` for ``train_loss``. The model is in
    train mode during the step and in eval mode after it.

    ``mesh`` (a distributed one; ``parallel.make_mesh``): data
    parallelism. ``batch`` is this process's block of B (the global
    micro-batch is ``data`` times larger), the draws are those of the
    global batch (drawn, or given, alike on every process), BatchNorm
    takes the global batch's statistics, and the gradients are reduced
    once a step, after the mean over A and before the clip
    (:func:`_reduce_and_update_`; ZeRO-1 when the state was created with
    ``train.zero1``). The loss returned is the global batch's."""
    tc, dc = cfg.train, cfg.diffusion
    acc_dtype = _DTYPES[tc.grad_accum_dtype]
    net = remat_denoiser(model, tc.remat, tc.remat_policy)
    mesh = _data_mesh(mesh)

    def step(state: TrainState, batch: Dict, generator=None,
             draws: Optional[Sequence[Dict]] = None) -> torch.Tensor:
        with tracing.span("train.step"):
            return _step(state, batch, generator, draws)

    def _step(state, batch, generator, draws) -> torch.Tensor:
        params = state.params
        dev = params[0].device
        a = int(batch["x"].shape[0])
        masks = batch.get("mask")
        acc = (None if acc_dtype == _F32
               else [torch.zeros_like(p, dtype=acc_dtype) for p in params])
        for p in params:
            p.grad = None
        loss_sum = torch.zeros((), dtype=_F32, device=dev)
        sp = attach(model, mesh)
        bn_group = None
        if mesh is not None:
            bn_group = (mesh.data_spatial_group() if sp is not None
                        else mesh.group("data"))
        model.train()
        try:
            for i in range(a):
                with tracing.span("train.feed"):
                    x, mask = decode_wire(
                        _to(batch["x"][i], dev),
                        _to(masks[i], dev) if masks is not None else None,
                        dc, normalize_u8)
                    c = _to(batch["c"][i], dev).long()
                slab = is_slab(sp, x.movedim(3, 1))  # NHWC -> NCHW view
                with tracing.span("train.fwd_bwd"), \
                        global_batch_stats(model, bn_group):
                    loss = train_loss(net, x, c, mask, sched, dc,
                                      generator=generator,
                                      **_local_draws(mesh, dc, x, generator,
                                                     draws[i] if draws
                                                     else None, slab))
                    loss.backward()
                with tracing.span("train.accum"):
                    loss_sum = loss_sum + loss.detach()
                    if acc is not None:
                        with torch.no_grad():
                            for s, p in zip(acc, params):
                                if p.grad is not None:
                                    s.add_(p.grad.to(acc_dtype))
                                p.grad = None
        finally:
            model.eval()
        if acc is None:
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
        else:
            grads = [s.to(_F32) for s in acc]
            del acc
        for p in params:
            p.grad = None
        torch._foreach_div_(grads, float(a))
        loss = loss_sum / a
        with tracing.span("train.optimizer"):
            if mesh is None:
                apply_updates_(opt, state.opt_state, params, grads)
            else:
                loss = _reduce_and_update_(opt, state, mesh, grads, loss)
        if state.ema is not None:
            with tracing.span("train.ema"):
                update_ema_(state, tc.ema_decay)
        state.step += 1
        return loss

    return step


def make_eval_step(model: nn.Module, sched: Schedule, cfg: Config,
                   normalize_u8: bool = True, mesh: Optional[Mesh] = None):
    """Returns ``step(state, batch, generator=None) -> loss``: the
    validation loss of one (non-accumulated) batch in eval mode, without
    gradients; with ``model.use_pallas`` SE and CoordAttn run the CUDA
    kernels. Uses the live parameters, as the JAX package does. Under a
    distributed ``mesh`` ``batch`` is this process's block, the draws are
    the global batch's and the loss is averaged over 'data' (and over
    'spatial', whose processes hold H-slabs when the model carries the
    spatial hooks)."""
    dc = cfg.diffusion
    mesh = _data_mesh(mesh)

    @torch.no_grad()
    def step(state: TrainState, batch: Dict, generator=None) -> torch.Tensor:
        dev = next(model.parameters()).device
        model.eval()
        sp = attach(model, mesh)
        x, mask = decode_wire(_to(batch["x"], dev),
                              _to(batch.get("mask"), dev), dc, normalize_u8)
        loss = train_loss(model, x, _to(batch["c"], dev).long(), mask, sched,
                          dc, generator=generator,
                          **_local_draws(mesh, dc, x, generator, None,
                                         is_slab(sp, x.movedim(3, 1))))
        if mesh is None:
            return loss
        return all_reduce_mean_(mesh, all_reduce_mean_(mesh, loss),
                                "spatial")

    return step


class EarlyStop:
    """Patience-based early stopping (new_scripy.py:587-620); the best
    state is kept on the host as the JAX package's numpy trees, ready to
    be written as a checkpoint."""

    def __init__(self, patience: int = 10, min_delta: float = 1e-3,
                 verbose: bool = True, snapshot_min_epochs: int = 0):
        self.patience = patience
        self.min_delta = min_delta
        self.verbose = verbose
        self.counter = 0
        self.best_loss = float("inf")
        self.early_stop = False
        self.best_state: Optional[dict] = None
        self.snapshot_min_epochs = snapshot_min_epochs

    def __call__(self, val_loss: float, state: TrainState, epoch: int) -> bool:
        if val_loss < self.best_loss - self.min_delta:
            self.best_loss = val_loss
            self.counter = 0
            if self.verbose:
                print(f"Val loss improved to {val_loss:.6f}", flush=True)
            if (self.best_state is not None and self.snapshot_min_epochs > 0
                    and epoch - self.best_state["epoch"]
                    < self.snapshot_min_epochs):
                return False  # improved, but snapshot not refreshed yet
            params, batch_stats = host_trees(state.model)
            self.best_state = {"epoch": epoch, "params": params,
                               "batch_stats": batch_stats,
                               "val_loss": val_loss}
            if state.ema is not None:
                self.best_state["ema_params"] = host_trees(state.ema)[0]
            return True
        self.counter += 1
        if self.verbose:
            print(f"Val loss not improved, patience: "
                  f"{self.counter}/{self.patience}")
        if self.counter >= self.patience:
            self.early_stop = True
            if self.verbose:
                print("Early stopping triggered.")
        return False
