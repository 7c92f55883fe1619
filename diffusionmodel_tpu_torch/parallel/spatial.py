"""The spatial axis: H-slabs of NHWC activations over ``torch.distributed``
(counterpart of ``diffusionmodel_tpu/parallel/spatial.py``).

Each process of a 'spatial' group holds an H-slab of every large feature
map (equal slabs, in rank order, as the JAX package's ``image_sharding``
lays an NHWC batch out) and the global quantities come from collectives
over the group. JAX leaves this to GSPMD (halo exchanges and ``psum``);
here it is spelled out, and every transport is an ``all_reduce`` or a
``broadcast``, which gloo also runs on CUDA tensors:

- :class:`SpatialGroup` holds the group, its size and this process's
  rank, with the transport: :meth:`~SpatialGroup.all_reduce` (a
  differentiable sum), :meth:`~SpatialGroup.gather` (the whole tensor on
  every process: the all_reduce of a zero buffer holding this slab's
  rows), :meth:`~SpatialGroup.take` (this process's rows, no
  communication) and :meth:`~SpatialGroup.halo` (:func:`halo_exchange`).
- :func:`halo_exchange`: the neighbours' boundary rows around a slab,
  zeros at the image's edges, for a convolution on the slab; its backward
  adds the halo's gradients back into the owners' rows.
- :func:`constrain_spatial`: the JAX package's rule for a map inside the
  sharded forward: H split while every slab holds at least ``min_rows``
  rows, gathered (replicated) below.
- :func:`runs_on_slabs` is the JAX package's condition for the layout,
  and :func:`attach` gives a model's slab-aware layers the group where it
  holds.

Gradients follow the sum of the processes' losses: the backward of a sum
over the group is a sum over the group, so each process's parameter
gradient holds its share and the train step sums (averages) them over
data x spatial.

Inside the ContextUnet every map is square (``img_size``), so a layer
tells a slab from a whole map by its shape (:func:`is_slab`: fewer rows
than columns).

The three JAX helpers below (:func:`sharded_global_mean`,
:func:`sharded_se_block`, :func:`sharded_directional_pools`) keep their
semantics on slabs split over any axis.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from diffusionmodel_tpu_torch.parallel.mesh import Mesh

MIN_ROWS = 8  # the JAX package's constrain_spatial threshold


def _transport(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` into a new tensor. Types gloo may lack
    (bf16, fp16) travel as float32, which holds them exactly: a gather
    adds zeros, and the sums taken here are float32 or float64."""
    y = x.float() if x.dtype in (torch.bfloat16, torch.float16) else \
        x.clone()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _AllReduceSum(torch.autograd.Function):
    """The sum over ``group``; its backward is the sum of the gradients
    over ``group`` (each process's loss depends on the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _transport(x, group)

    @staticmethod
    def backward(ctx, g):
        return _transport(g, ctx.group), None


class _Halo(torch.autograd.Function):
    """See :func:`halo_exchange`. One all_reduce of a [S, up + down, ...]
    buffer (rows first) in which each process writes its first ``down``
    and its last ``up`` rows; the backward sends the halo's gradients
    back the same way."""

    @staticmethod
    def forward(ctx, x, up, down, sp):
        ctx.up, ctx.down, ctx.sp = up, down, sp
        s, r = sp.shards, sp.rank
        rows = x.movedim(2, 0)
        buf = rows.new_zeros((s, up + down, *rows.shape[1:]))
        buf[r, :down] = rows[:down]
        buf[r, down:] = rows[rows.shape[0] - up:]
        buf = _transport(buf, sp.group)
        above = buf[r - 1, down:] if r > 0 else buf.new_zeros(
            (up, *rows.shape[1:]))
        below = buf[r + 1, :down] if r < s - 1 else buf.new_zeros(
            (down, *rows.shape[1:]))
        return _channels_last(torch.cat([above, rows, below]).movedim(0, 2))

    @staticmethod
    def backward(ctx, g):
        up, down, sp = ctx.up, ctx.down, ctx.sp
        s, r = sp.shards, sp.rank
        rows = g.movedim(2, 0)
        h = rows.shape[0] - up - down
        buf = rows.new_zeros((s, up + down, *rows.shape[1:]))
        buf[r, :up] = rows[:up]
        buf[r, up:] = rows[up + h:]
        buf = _transport(buf, sp.group)
        gx = rows[up:up + h].clone()
        if r > 0:  # the neighbour above held our first rows below it
            gx[:down] += buf[r - 1, up:]
        if r < s - 1:  # the neighbour below held our last rows above it
            gx[h - up:] += buf[r + 1, :up]
        return _channels_last(gx.movedim(0, 2)), None, None, None


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous(memory_format=torch.channels_last) \
        if x.dim() == 4 else x.contiguous()


class SpatialGroup:
    """The 'spatial' axis of a mesh as the slab-aware layers use it. A
    handle: copies of a model (the EMA shadow) share it."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.shards = mesh.shape["spatial"]
        self.rank = mesh.rank("spatial")
        self.group = mesh.group("spatial")

    def __deepcopy__(self, memo):
        return self

    def row0(self, rows: int) -> int:
        """The first global row of this process's slab of ``rows`` rows."""
        return self.rank * rows

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the group (differentiable)."""
        return _AllReduceSum.apply(x, self.group)

    def gather(self, x: torch.Tensor, dim: int = 2) -> torch.Tensor:
        """The whole tensor from this process's block ``x`` along ``dim``,
        on every process (differentiable: the backward sums the
        gradients over the group and takes this block's)."""
        k = x.shape[dim]
        pad = [0, 0] * (x.dim() - 1 - dim) + [
            self.rank * k, (self.shards - 1 - self.rank) * k]
        return _channels_last(self.all_reduce(F.pad(x, pad)))

    def take(self, x: torch.Tensor, dim: int = 2) -> torch.Tensor:
        """This process's block of the whole tensor ``x`` along ``dim``."""
        n = x.shape[dim]
        if n % self.shards:
            raise ValueError(f"{n} rows do not split over {self.shards} "
                             "'spatial' processes")
        k = n // self.shards
        out = x.narrow(dim, self.rank * k, k)
        return _channels_last(out) if x.dim() == 4 else out.contiguous()

    def halo(self, x: torch.Tensor, up: int, down: int) -> torch.Tensor:
        return halo_exchange(x, up, down, self)


def halo_exchange(x: torch.Tensor, up: int, down: int,
                  sp: SpatialGroup) -> torch.Tensor:
    """The slab x [B, C, h, W] (NCHW) with ``up`` rows of the slab above
    and ``down`` rows of the slab below around it, zero rows at the
    image's top and bottom: [B, C, up + h + down, W]. Differentiable: the
    backward adds the gradients of the halo rows into the rows of the
    processes that own them."""
    if max(up, down) > x.shape[2]:
        raise ValueError(f"a halo of {max(up, down)} rows around a slab of "
                         f"{x.shape[2]}")
    if up == down == 0:
        return x
    return _Halo.apply(x, up, down, sp)


def is_slab(sp: Optional[SpatialGroup], x: torch.Tensor) -> bool:
    """Whether the NCHW map ``x`` is this process's H-slab: a group is
    attached and the map (square when whole) has fewer rows than
    columns."""
    return sp is not None and x.shape[-2] < x.shape[-1]


def constrain_spatial(x: torch.Tensor, sp: Optional[SpatialGroup],
                      min_rows: int = MIN_ROWS) -> torch.Tensor:
    """The JAX package's layout rule for an NCHW map inside the sharded
    forward: H split over the group while each slab holds at least
    ``min_rows`` rows, whole below that. A gather when a slab must become
    whole, a slice when a whole map must become a slab; nothing when the
    layout already is the rule's."""
    if sp is None or sp.shards <= 1:
        return x
    want = x.shape[-1] // sp.shards >= min_rows
    if is_slab(sp, x) == want:
        return x
    return sp.take(x) if want else sp.gather(x)


def match_layout(x: torch.Tensor, like: torch.Tensor,
                 sp: Optional[SpatialGroup]) -> torch.Tensor:
    """``x`` (NCHW, or [B, H, W]) as a slab when ``like`` is one, whole
    otherwise."""
    if sp is None:
        return x
    squeeze = x.dim() == 3
    t = x[:, None] if squeeze else x
    if is_slab(sp, t) != is_slab(sp, like):
        t = sp.take(t) if is_slab(sp, like) else sp.gather(t)
    return t[:, 0] if squeeze else t


def runs_on_slabs(model: nn.Module, mesh: Optional[Mesh]) -> bool:
    """The JAX package's condition for the big-image layout
    (``trainer.py:91,436``): a mesh over processes whose 'spatial' axis is
    > 1 and divides the model's ``img_size``, and a model with the spatial
    hooks (``spatial_shards`` > 0, here equal to the axis). Where the axis
    does not divide ``img_size`` the processes along it hold whole images
    (the batch is sharded over 'data' only)."""
    shards = getattr(model, "spatial_shards", 0)
    if (mesh is None or not mesh.distributed or shards <= 1
            or mesh.shape["spatial"] <= 1):
        return False
    if shards != mesh.shape["spatial"]:
        raise ValueError(f"the model carries {shards} spatial shards, the "
                         f"mesh's 'spatial' axis {mesh.shape['spatial']}")
    return model.img_size % shards == 0


def attach(model: nn.Module, mesh: Optional[Mesh]
           ) -> Optional[SpatialGroup]:
    """Give ``model``'s slab-aware layers the 'spatial' group of ``mesh``
    where :func:`runs_on_slabs` holds; otherwise take any group away.
    Returns the group the model now runs on slabs over, or None."""
    sp = SpatialGroup(mesh) if runs_on_slabs(model, mesh) else None
    for m in model.modules():
        if hasattr(m, "spatial"):
            m.spatial = sp
    return sp


# ------------------------------------------------ the JAX package's helpers
def _sum_over(mesh: Mesh, x: torch.Tensor, axis_name: str) -> torch.Tensor:
    if mesh.distributed:
        return _AllReduceSum.apply(x, mesh.group(axis_name))
    return x


def sharded_global_mean(mesh: Mesh, x: torch.Tensor,
                        axis_name: str = "data") -> torch.Tensor:
    """x: this process's slab [B, h, W, C] -> the global mean [B, C]."""
    total = _sum_over(mesh, x.sum(dim=(1, 2)), axis_name)
    return total / (x.shape[1] * mesh.shape[axis_name] * x.shape[2])


def sharded_se_block(mesh: Mesh, x: torch.Tensor, w1: torch.Tensor,
                     w2: torch.Tensor, axis_name: str = "data"
                     ) -> torch.Tensor:
    """SE on a slab: ``x * sigmoid(gelu(mean @ w1) @ w2)`` with the mean
    over the whole image (w1 [C, R], w2 [R, C]: the JAX layout)."""
    pooled = sharded_global_mean(mesh, x, axis_name)
    y = torch.sigmoid(F.gelu(pooled @ w1) @ w2)
    return x * y[:, None, None, :]


def sharded_directional_pools(mesh: Mesh, x: torch.Tensor,
                              axis_name: str = "data"
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CoordAttn's pools of a slab: (x_h [B, h, C], this slab's rows of
    the mean over W; x_w [B, W, C], the mean over the whole H)."""
    x_h = x.mean(dim=2)
    x_w = _sum_over(mesh, x.sum(dim=1), axis_name)
    return x_h, x_w / (x.shape[1] * mesh.shape[axis_name])
