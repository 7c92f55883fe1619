"""Process mesh and sharding rules over ``torch.distributed``
(counterpart of ``diffusionmodel_tpu/parallel/mesh.py``).

PyTorch's idiom is one process per card (``torchrun``), where JAX runs
one controller over every chip, so a "sharding" here is a statement of
which contiguous block of a tensor axis this process holds:

- :func:`make_mesh` lays the processes out as a 3-axis mesh ``('data',
  'model', 'spatial')`` over a ``DeviceMesh``, rank ``d*(m*s) + i*s + j``
  at coordinate ``(d, i, j)``, as the JAX package reshapes its device
  list. Without a process group it is the trivial 1x1x1 mesh.
- :class:`Sharding` maps tensor dims to mesh axes: ``local`` takes this
  process's block, ``gather`` concatenates every block back in rank order
  (an ``all_reduce`` of a zero buffer holding this block, which gloo runs
  on CUDA tensors too). :func:`replicated`, :func:`batch_sharding` and
  :func:`image_sharding` (batch over 'data', H over 'spatial') are the
  JAX package's three layouts.
- :func:`opt_state_shardings` is JAX's ZeRO-1 rule: a moment of at least
  ``min_size`` elements is partitioned over 'data' along its largest dim
  that the data size divides; every other leaf is replicated. The rule
  reads each parameter's shape in the flax layout (kernels
  [kh,kw,I,O], dense [I,O]; ``compat.flax_bridge.flax_axes``), so it
  picks the same dim as JAX's, ties included, and maps it to the port's
  layout.
- :func:`param_shardings` is JAX's output-channel rule for the 'model'
  axis: the layout every process holds its parameters, EMA and moments
  in once ``parallel.tensor.attach_model_axis`` has cut them.

The three axes run: the train step, the loader, the samplers and ``fit``
shard over 'data' and 'spatial' (``parallel.spatial`` holds the spatially
sharded forward's transport) and split wide layers' output channels over
'model' (``parallel.tensor``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from diffusionmodel_tpu_torch.compat.flax_bridge import flax_axes

AXES = ("data", "model", "spatial")


class Mesh:
    """The 3-axis process mesh. ``shape`` maps each axis to its size, as
    ``jax.sharding.Mesh.shape`` does; ``device_mesh`` is the
    ``DeviceMesh`` behind it, None for the trivial mesh of a process that
    started no group (no collective runs on it)."""

    def __init__(self, shape: Dict[str, int], device_mesh=None):
        self.shape = dict(shape)
        self.device_mesh = device_mesh
        self._data_spatial = None
        if device_mesh is not None and self.shape.get("model", 1) > 1:
            self._data_spatial = _data_spatial_groups(self.shape)[
                self.rank("model")]

    @property
    def distributed(self) -> bool:
        return self.device_mesh is not None

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def rank(self, axis: str) -> int:
        """This process's coordinate along ``axis``."""
        if self.device_mesh is None:
            return 0
        return self.device_mesh.get_local_rank(axis)

    def data_spatial_group(self):
        """The group of 'data' x 'spatial' that holds this process: the
        processes that share its 'model' coordinate (every process when
        the axis is 1)."""
        if self._data_spatial is None:
            return dist.group.WORLD
        return self._data_spatial

    @property
    def is_main(self) -> bool:
        """Rank 0 of the group: the process that writes files and prints."""
        return self.device_mesh is None or dist.get_rank() == 0

    def __repr__(self):
        return (f"Mesh({self.shape}, "
                f"{'distributed' if self.distributed else 'one process'})")


def mesh_shape(data: int = -1, model: int = 1, spatial: int = 1
               ) -> Dict[str, int]:
    """The axis sizes of :func:`make_mesh`, checked against the default
    group without building anything; ``data=-1`` takes what ``model *
    spatial`` leaves. Without a process group only the trivial shape
    passes (no mesh runs on one process silently); with one, the mesh
    must hold every process."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data == -1:
        data = max(1, world // (model * spatial))
    shape = dict(zip(AXES, (data, model, spatial)))
    n = data * model * spatial
    if n > world:
        raise ValueError(
            f"mesh {data}x{model}x{spatial} needs {n} processes, the "
            f"process group has {world}"
            + ("" if dist.is_initialized() else
               " (none started: run under torchrun, which starts one per "
               "card)"))
    if n < world:
        raise ValueError(f"mesh {data}x{model}x{spatial} leaves "
                         f"{world - n} of {world} processes out")
    return shape


def make_mesh(data: int = -1, model: int = 1, spatial: int = 1) -> Mesh:
    """The mesh of :func:`mesh_shape` over every process of the default
    group; without a process group, the trivial mesh."""
    shape = mesh_shape(data, model, spatial)
    if not dist.is_initialized():
        return Mesh(shape)
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(shape, init_device_mesh(device_type, tuple(shape.values()),
                                        mesh_dim_names=AXES))


def _data_spatial_groups(shape: Dict[str, int]) -> list:
    """One group per 'model' coordinate i: the processes ``d*(m*s) + i*s
    + j`` of every (d, j). Every process creates every group, in the same
    order (``dist.new_group`` is a collective over the default group)."""
    d, m, s = (shape[a] for a in AXES)
    return [dist.new_group([a * m * s + i * s + j for a in range(d)
                            for j in range(s)]) for i in range(m)]


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Which block of a tensor this process holds: ``dims`` maps a tensor
    dim to the mesh axis it is split over (contiguous, equal blocks in
    rank order); dims not named are replicated."""

    mesh: Mesh
    dims: Tuple[Tuple[int, str], ...] = ()

    @property
    def is_replicated(self) -> bool:
        return all(self.mesh.shape[a] == 1 for _, a in self.dims)

    def block(self, dim: int, length: int) -> slice:
        """This process's rows of ``dim`` for a global length ``length``."""
        axis = dict(self.dims).get(dim)
        if axis is None:
            return slice(0, length)
        n = self.mesh.shape[axis]
        if length % n:
            raise ValueError(f"dim {dim} of length {length} does not split "
                             f"over {n} '{axis}' ranks")
        k = length // n
        r = self.mesh.rank(axis)
        return slice(r * k, (r + 1) * k)

    def local(self, x):
        """This process's block of the global ``x`` (a view; a tensor or a
        numpy array)."""
        for dim, _ in self.dims:
            x = x[(slice(None),) * dim + (self.block(dim, x.shape[dim]),)]
        return x

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global tensor from every process's block ``x`` (a
        collective: every process of each axis calls it): per axis, last
        split first, an ``all_reduce`` of a zero buffer in which this
        process's block stands at its place (float32 for bf16, which it
        holds exactly)."""
        for dim, axis in reversed(self.dims):
            n = self.mesh.shape[axis]
            if not self.mesh.distributed:
                continue
            k = x.shape[dim]
            shape = list(x.shape)
            shape[dim] = n * k
            wire = torch.float32 if x.dtype in (torch.bfloat16,
                                                torch.float16) else x.dtype
            out = torch.zeros(shape, dtype=wire, device=x.device)
            out.narrow(dim, self.mesh.rank(axis) * k, k).copy_(x)
            dist.all_reduce(out, group=self.mesh.group(axis))
            x = out.to(x.dtype)
        return x


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh)


def batch_sharding(mesh: Mesh, ndim: int, batch_axis: int = 0) -> Sharding:
    """Split axis ``batch_axis`` of an ``ndim``-dim tensor over 'data'."""
    if not 0 <= batch_axis < ndim:
        raise ValueError(f"batch_axis {batch_axis} of a {ndim}-dim tensor")
    return Sharding(mesh, ((batch_axis, "data"),))


def image_sharding(mesh: Mesh, ndim: int = 4, batch_axis: int = 0,
                   h_axis: int = 1) -> Sharding:
    """Split axis ``batch_axis`` over 'data' and axis ``h_axis`` (an
    image's H) over 'spatial': the big-image layout, each process holding
    an H-slab of its block of the batch."""
    if not (0 <= batch_axis < ndim and 0 <= h_axis < ndim
            and batch_axis != h_axis):
        raise ValueError(f"batch_axis {batch_axis}, h_axis {h_axis} of a "
                         f"{ndim}-dim tensor")
    return Sharding(mesh, ((batch_axis, "data"), (h_axis, "spatial")))


def partition_dim(flax_shape, n_data: int, min_size: int) -> Optional[int]:
    """JAX's ZeRO-1 choice on a flax-layout shape: the largest dim the
    data size divides (the first of equals), on leaves of at least
    ``min_size`` elements; None to replicate."""
    numel = 1
    for s in flax_shape:
        numel *= s
    if n_data <= 1 or not flax_shape or numel < min_size:
        return None
    cands = [d for d, s in enumerate(flax_shape)
             if s % n_data == 0 and s >= n_data]
    return max(cands, key=lambda i: flax_shape[i]) if cands else None


def _flax_shape(shape, axes):
    return tuple(shape[a] for a in axes)


def opt_state_shardings(mesh: Mesh, model: nn.Module,
                        min_size: int = 1 << 14) -> Dict[str, Sharding]:
    """ZeRO-1: the sharding of each Adam moment, by parameter name (the
    moments have their parameter's shape). Partition over 'data' per
    :func:`partition_dim` on the flax layout; replicate the rest
    (biases, norm scales, CoordAttn's scalars, small kernels)."""
    n = mesh.shape["data"]
    out = {}
    for name, p in model.named_parameters():
        axes = flax_axes(model, name, p.dim())
        d = partition_dim(_flax_shape(p.shape, axes), n, min_size)
        out[name] = (Sharding(mesh, ((axes[d], "data"),)) if d is not None
                     else replicated(mesh))
    return out


def _leaf_spec(path: str, shape, model_size: int, min_channels: int
               ) -> Optional[int]:
    """Tensor-parallel rule on a flax-layout kernel shape: the output
    feature dim (the last), when the model size divides it and it has at
    least ``min_channels``; None to replicate."""
    if model_size <= 1 or len(shape) < 2:
        return None
    out = shape[-1]
    if out % model_size == 0 and out >= min_channels:
        return len(shape) - 1
    return None


def param_shardings(mesh: Mesh, model: nn.Module,
                    min_channels: int = 256) -> Dict[str, Sharding]:
    """The 'model' axis layout by parameter name: output-channel
    parallelism on wide conv / dense kernels (JAX's ``kernel`` leaves),
    biases and scales replicated. Read from the shapes ``model`` holds:
    call it on the whole model, before ``parallel.tensor.attach_model_axis``
    cuts it."""
    size = mesh.shape["model"]
    out = {}
    for name, p in model.named_parameters():
        axes = flax_axes(model, name, p.dim())
        d = None
        if p.dim() >= 2 and name.endswith(".weight"):
            d = _leaf_spec(name, _flax_shape(p.shape, axes), size,
                           min_channels)
        out[name] = (Sharding(mesh, ((axes[d], "model"),)) if d is not None
                     else replicated(mesh))
    return out


def init_from_env(device: str) -> bool:
    """Start the default process group from ``torchrun``'s environment
    (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``/``PORT``): NCCL on CUDA,
    gloo on the CPU; each process on ``cuda:{LOCAL_RANK}``. False (and
    nothing started) outside torchrun."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return False
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if cuda else "gloo", init_method="env://")
    return True


def all_reduce_mean_(mesh: Mesh, x: torch.Tensor, axis: str = "data"
                     ) -> torch.Tensor:
    """``x`` replaced in place by its mean over ``axis`` (a sum, then a
    division: gloo has no average)."""
    if mesh.distributed:
        dist.all_reduce(x, group=mesh.group(axis))
        x.div_(mesh.shape[axis])
    return x


def broadcast_object(mesh: Mesh, obj):
    """Rank 0's ``obj`` on every process."""
    if not mesh.distributed:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]
