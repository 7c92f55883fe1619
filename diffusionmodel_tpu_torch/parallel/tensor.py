"""The 'model' axis: output-channel tensor parallelism over
``torch.distributed`` (what GSPMD does for the JAX package's
``param_shardings`` layout, spelled out).

Each process of a 'model' group holds the contiguous block of output
channels that ``parallel.mesh.param_shardings`` gives it of every wide
conv and dense kernel (the EMA shadow's and Adam's moments alike); biases,
norms and everything else stay whole. A layer with a block computes its
output channels only and the whole map comes back on every process of the
group, so everything after it runs replicated over 'model':

- :func:`attach_model_axis` cuts a model's planned parameters to their
  blocks (``Sharding.local(...).clone()``) and gives each such layer a
  :class:`ModelShard`, the handle on the group;
- :meth:`ModelShard.gather` (an autograd function) is the whole map from
  the blocks: the ``all_reduce`` of a zero buffer in which each process's
  block stands at its place (float32 on the wire for bf16, as
  ``Sharding.gather`` and the spatial halo carry it, so gloo takes CUDA
  tensors). Its backward takes this process's block of the gradient and
  communicates nothing: the gradient that reaches it is the replicated
  computation's, the same on every process;
- :meth:`ModelShard.enter` is the identity whose backward sums the input
  gradient over 'model' (each process's block contributes its share);
- :func:`full_weight` is a blocked weight gathered whole, for consumers
  that need all of it (the SE and CoordAttn kernels and their twins, as
  GSPMD gathers a Pallas call's sharded operands); its backward keeps
  this process's block of the gradient.

A layer adds its (replicated) bias after the gather, on the whole map, so
every process computes the bias gradient alike and the replicas do not
drift; in bf16 that is also JAX's order (the product rounded, then the
bias added in bf16). The train step reads :func:`model_shardings` to
average gradients over 'data' x 'spatial' only and to sum the blocks'
squares over 'model' in the clip's norm; checkpoints gather the blocks
(:func:`full_state_dict`) and loading cuts them again
(:func:`local_state_dict`), so a file does not depend on the mesh.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from diffusionmodel_tpu_torch.parallel.mesh import (
    Mesh,
    Sharding,
    param_shardings,
)
from diffusionmodel_tpu_torch.parallel.spatial import _transport

_NARROW = (torch.bfloat16, torch.float16)


class ModelShard:
    """A layer's handle on the 'model' axis: its weight holds this
    process's block of dim ``dim`` (the output channels). A handle:
    copies of a model (the EMA shadow) share it."""

    def __init__(self, mesh: Mesh, dim: int):
        self.mesh = mesh
        self.dim = dim
        self.size = mesh.shape["model"]
        self.rank = mesh.rank("model")
        self.group = mesh.group("model")

    def __deepcopy__(self, memo):
        return self

    @property
    def sharding(self) -> Sharding:
        return Sharding(self.mesh, ((self.dim, "model"),))

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as it is; its gradient summed over 'model'."""
        return _SumGradOverModel.apply(x, self)

    def gather(self, y: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole tensor from this process's block ``y`` along ``dim``
        (differentiable; channels_last kept for a 4-dim map)."""
        return _GatherOverModel.apply(y, dim, self)


def _zeros_like_whole(y: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    shape = list(y.shape)
    shape[dim] *= n
    wire = torch.float32 if y.dtype in _NARROW else y.dtype
    out = torch.zeros(shape, dtype=wire, device=y.device)
    if y.dim() == 4 and dim == 1:  # an NCHW map: channels_last memory
        out = out.contiguous(memory_format=torch.channels_last)
    return out


class _GatherOverModel(torch.autograd.Function):
    wire_bytes = 0  # bytes all_reduced by the forward gathers, a counter

    @staticmethod
    def forward(ctx, y, dim, shard):
        ctx.dim, ctx.shard = dim, shard
        k = y.shape[dim]
        out = _zeros_like_whole(y, dim, shard.size)
        out.narrow(dim, shard.rank * k, k).copy_(y)
        dist.all_reduce(out, group=shard.group)
        _GatherOverModel.wire_bytes += out.numel() * out.element_size()
        return out.to(y.dtype)

    @staticmethod
    def backward(ctx, g):
        shard, dim = ctx.shard, ctx.dim
        k = g.shape[dim] // shard.size
        mine = g.narrow(dim, shard.rank * k, k)
        fmt = (torch.channels_last if g.dim() == 4 and dim == 1
               else torch.contiguous_format)
        return mine.contiguous(memory_format=fmt), None, None


class _SumGradOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.group = shard.group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _transport(g, ctx.group), None


def gathered_bytes(reset: bool = False) -> int:
    """The bytes the forward gathers have all_reduced in this process
    (the buffers' size: float32 for bf16 maps); ``reset`` sets the count
    to 0 after reading it."""
    n = _GatherOverModel.wire_bytes
    if reset:
        _GatherOverModel.wire_bytes = 0
    return n


def shard_of(layer: nn.Module) -> Optional[ModelShard]:
    return getattr(layer, "model_shard", None)


def full_weight(layer: nn.Module) -> torch.Tensor:
    """``layer.weight`` whole: gathered over 'model' when the layer holds
    a block of it (differentiable), else the weight itself."""
    shard = shard_of(layer)
    if shard is None:
        return layer.weight
    return shard.gather(layer.weight, shard.dim)


def attach_model_axis(model: nn.Module, mesh: Optional[Mesh],
                      min_channels: int = 256) -> int:
    """Cut ``model``'s parameters to the blocks ``param_shardings(mesh,
    model, min_channels)`` gives this process and hand each cut layer its
    :class:`ModelShard`. Nothing without a distributed mesh whose 'model'
    axis is > 1, and nothing for a layer already cut (so a second call,
    or one on the EMA copy of a cut model, changes nothing). Returns the
    number of layers cut by this call. Raises for a planned parameter of
    a layer that cannot run on a block (a layer class without
    ``model_shard``)."""
    if mesh is None or not mesh.distributed or mesh.shape["model"] <= 1:
        return 0
    plan = param_shardings(mesh, model, min_channels)
    cut = 0
    for name, sh in plan.items():
        if sh.is_replicated:
            continue
        owner_name, _, leaf = name.rpartition(".")
        owner = model.get_submodule(owner_name)
        if shard_of(owner) is not None:
            continue
        if leaf != "weight" or not hasattr(type(owner), "model_shard"):
            raise TypeError(
                f"{name} ({type(owner).__name__}) cannot hold a block of "
                "its output channels over 'model'")
        p = getattr(owner, leaf)
        block = nn.Parameter(sh.local(p.detach()).clone(),
                             requires_grad=p.requires_grad)
        setattr(owner, leaf, block)
        owner.model_shard = ModelShard(mesh, sh.dims[0][0])
        cut += 1
    return cut


def model_shardings(model: nn.Module) -> Dict[str, Sharding]:
    """The 'model' sharding of each parameter that holds a block, by
    name (empty for a model not cut)."""
    out = {}
    for name, _ in model.named_parameters():
        owner_name, _, leaf = name.rpartition(".")
        shard = shard_of(model.get_submodule(owner_name))
        if shard is not None and leaf == "weight":
            out[name] = shard.sharding
    return out


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every block gathered whole (a
    collective over 'model' when the model is cut: every process of the
    group calls it)."""
    sd = model.state_dict()
    for name, sh in model_shardings(model).items():
        sd[name] = sh.gather(sd[name].detach())
    return sd


def local_state_dict(model: nn.Module, sd: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """A whole ``state_dict`` cut to the blocks ``model`` holds (no
    communication), for ``load_state_dict``."""
    cut = dict(sd)
    for name, sh in model_shardings(model).items():
        cut[name] = sh.local(sd[name])
    return cut
