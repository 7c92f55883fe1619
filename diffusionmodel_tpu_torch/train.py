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

PyTorch updates the model and the optimizer state in place, so a step
returns only its loss (a float32 scalar tensor on the device).
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from diffusionmodel_tpu_torch.compat.flax_bridge import flax_trees
from diffusionmodel_tpu_torch.config import Config
from diffusionmodel_tpu_torch.diffusion import Schedule, train_loss
from diffusionmodel_tpu_torch.lr_schedules import build_schedule

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
    ``count`` steps taken, ``mu`` in the moment dtype, ``nu`` in float32."""

    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


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


def init_opt_state(opt: Optimizer, params: Sequence[torch.Tensor]) -> OptState:
    return OptState(
        count=0,
        mu=[torch.zeros_like(p, dtype=opt.mu_dtype) for p in params],
        nu=[torch.zeros_like(p, dtype=_F32) for p in params])


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm in place: unchanged below ``max_norm``,
    else ``(g / norm) * max_norm``, with no epsilon. Stays on the device
    (no host synchronisation)."""
    norm = global_norm(grads)
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))


@torch.no_grad()
def apply_updates_(opt: Optimizer, state: OptState,
                   params: List[torch.Tensor],
                   grads: List[torch.Tensor]) -> float:
    """One optimizer step in place on ``params`` and ``state``; ``grads``
    is consumed (overwritten). Returns the rate used. Op for op:

        g   <- clip(g)
        nu  <- (1-b2) g^2 + b2 nu
        mu  <- (1-b1) g + b1 mu          (b1 rounded to mu's dtype)
        u   <- (mu / (1-b1^n)) / (sqrt(nu / (1-b2^n)) + eps) + wd p
        p   <- p + (-lr) u,   lr = schedule(n - 1),  mu stored cast."""
    if opt.grad_clip > 0:
        clip_by_global_norm_(grads, opt.grad_clip)
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


def create_train_state(model: nn.Module, cfg: Config, steps_per_epoch: int
                       ) -> tuple:
    """(TrainState, Optimizer) over ``model`` as it is (the port's
    ``build_model`` draws the initial weights from the torch seed)."""
    opt = build_optimizer(cfg, steps_per_epoch)
    state = TrainState(step=0, model=model,
                       opt_state=init_opt_state(opt, list(model.parameters())),
                       ema=_ema_copy(model) if cfg.train.ema_decay > 0
                       else None)
    return state, opt


def host_trees(model: nn.Module) -> tuple:
    """(params, batch_stats) of ``model`` as the JAX package's numpy trees
    (the walk of its arch, ``model.layout``)."""
    return flax_trees(model)


def opt_state_to_host(model: nn.Module, st: OptState) -> Dict:
    """The port's optimizer state as numpy copies: ``count`` and ``mu`` /
    ``nu`` by parameter name (``mu`` widened to float32, which is exact)."""
    names = [n for n, _ in model.named_parameters()]
    return {"count": int(st.count),
            "mu": {n: m.detach().float().cpu().numpy().copy()
                   for n, m in zip(names, st.mu)},
            "nu": {n: v.detach().cpu().numpy().copy()
                   for n, v in zip(names, st.nu)}}


def opt_state_from_host(model: nn.Module, st: OptState, host) -> None:
    """Restore :func:`opt_state_to_host`'s layout in place, each moment
    cast to the dtype the run keeps it in. Raises on any other layout (the
    JAX package's optax state)."""
    if not (isinstance(host, dict) and {"count", "mu", "nu"} <= set(host)
            and isinstance(host["mu"], dict)):
        raise ValueError(f"not the port's optimizer layout: "
                         f"{type(host).__name__}")
    names = [n for n, _ in model.named_parameters()]
    missing = [n for n in names if n not in host["mu"] or n not in host["nu"]]
    if missing:
        raise ValueError(f"optimizer state lacks {missing[:3]}")
    with torch.no_grad():
        for n, m, v in zip(names, st.mu, st.nu):
            m.copy_(torch.from_numpy(np.asarray(host["mu"][n])))
            v.copy_(torch.from_numpy(np.asarray(host["nu"][n])))
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


def make_train_step(model: nn.Module, sched: Schedule, cfg: Config,
                    opt: Optimizer, normalize_u8: bool = True):
    """Returns ``step(state, batch, generator=None, draws=None) -> loss``.

    batch: ``x`` [A, B, H, W, C] (float, or the uint8 wire format), ``c``
    [A, B], ``mask`` [A, B, H, W] or None (float weights, or uint8 class
    indices); numpy arrays or tensors, moved to the model's device. A is
    the number of micro-batches. ``draws``: optionally A dicts of
    ``ts`` / ``noise`` / ``ctx_mask`` for ``train_loss``. The model is in
    train mode during the step and in eval mode after it."""
    tc, dc = cfg.train, cfg.diffusion
    acc_dtype = _DTYPES[tc.grad_accum_dtype]
    net = remat_denoiser(model, tc.remat, tc.remat_policy)

    def step(state: TrainState, batch: Dict, generator=None,
             draws: Optional[Sequence[Dict]] = None) -> torch.Tensor:
        params = state.params
        dev = params[0].device
        a = int(batch["x"].shape[0])
        masks = batch.get("mask")
        acc = (None if acc_dtype == _F32
               else [torch.zeros_like(p, dtype=acc_dtype) for p in params])
        for p in params:
            p.grad = None
        loss_sum = torch.zeros((), dtype=_F32, device=dev)
        model.train()
        try:
            for i in range(a):
                x, mask = decode_wire(
                    _to(batch["x"][i], dev),
                    _to(masks[i], dev) if masks is not None else None,
                    dc, normalize_u8)
                c = _to(batch["c"][i], dev).long()
                loss = train_loss(net, x, c, mask, sched, dc,
                                  generator=generator,
                                  **(draws[i] if draws else {}))
                loss.backward()
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
        apply_updates_(opt, state.opt_state, params, grads)
        if state.ema is not None:
            update_ema_(state, tc.ema_decay)
        state.step += 1
        return loss_sum / a

    return step


def make_eval_step(model: nn.Module, sched: Schedule, cfg: Config,
                   normalize_u8: bool = True):
    """Returns ``step(state, batch, generator=None) -> loss``: the
    validation loss of one (non-accumulated) batch in eval mode, without
    gradients; with ``model.use_pallas`` SE and CoordAttn run the CUDA
    kernels. Uses the live parameters, as the JAX package does."""
    dc = cfg.diffusion

    @torch.no_grad()
    def step(state: TrainState, batch: Dict, generator=None) -> torch.Tensor:
        dev = next(model.parameters()).device
        model.eval()
        x, mask = decode_wire(_to(batch["x"], dev),
                              _to(batch.get("mask"), dev), dc, normalize_u8)
        return train_loss(model, x, _to(batch["c"], dev).long(), mask, sched,
                          dc, generator=generator)

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
