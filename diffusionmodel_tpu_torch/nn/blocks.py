"""ContextUnet building blocks (counterpart of ``diffusionmodel_tpu/nn/blocks.py``).

Modules take and return NCHW tensors held in ``torch.channels_last``
memory, so that a block's tensor permuted to NHWC is contiguous — the
layout the kernels read. Attribute names follow the reference's
``state_dict`` (new_scripy.py:143-268): ``conv1.0``, ``se.fc.0``,
``channel_compress.0``, ``down.3.conv2.1``, ``model.0.1`` and so on, which
are the keys ``diffusionmodel_tpu/compat/torch_convert.py`` reads.

Mode follows PyTorch's ``module.training``, the JAX package's ``train``
argument: SEBlock takes the CUDA kernel only with ``use_pallas`` and in
eval mode, a bf16 GroupNorm only with ``use_pallas`` and without
gradients, and BatchNorm uses its running statistics in eval mode.

Compute type follows flax's policy, not ``torch.autocast``: every block
takes ``dtype`` (float32 or bfloat16), parameters stay float32, and each
layer casts its input and parameters to ``dtype`` where it uses them
(flax's ``promote_dtype``), so gradients reach the float32 parameters as
float32. The layers round where the JAX package's bf16 program rounds
(its jaxpr at the tiny size): a convolution or dense layer rounds its
product, then adds the bias in ``dtype`` and rounds again; a norm takes
its statistics and output in float32 and rounds once; the residual's
``/1.414`` divides by 1.414 rounded to ``dtype``. Operations that mix a
bf16 activation with a float32 value promote to float32, as in JAX: the
align-corners upsample (float32 interpolation matrices) and CoordAttn's
plain path (float32 scalars) return float32, which the next layer rounds.
At float32 every layer is the PyTorch layer it extends.

Spatial sharding (``parallel.spatial``): in a model given a 'spatial'
group (``spatial.attach``), a layer that meets an H-slab (a map with fewer
rows than columns) computes its rows of the whole map's result:
:class:`Conv2d` takes its kernel's halo rows from the neighbouring slabs,
:class:`GroupNorm` and :class:`SEBlock` sum their statistics over the
slabs, :class:`UpsampleBilinear2x` and the fused head read their source
rows by global index (one halo row each side), and BatchNorm takes the
data x spatial group the train step gives it. Without a group, or on a
whole map, every layer is the one above.

Tensor parallelism (``parallel.tensor``): in a model cut over 'model'
(``attach_model_axis``), :class:`Conv2d`, :class:`ConvTranspose2d`,
:class:`Linear` and the fused head hold a block of their output channels,
compute those, gather the whole map and add the bias to it; SE gathers
its weights whole. Everything else runs replicated.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from diffusionmodel_tpu_torch.kernels import (
    per_sample_conv,
    per_sample_matmul,
)
from diffusionmodel_tpu_torch.kernels.group_norm import (
    activation,
    gelu,
    group_norm_act,
    group_norm_f32,
    on_card,
    takes,
)
from diffusionmodel_tpu_torch.kernels.se_block import se_block, se_block_slab
from diffusionmodel_tpu_torch.ops.fused_upconv import (
    up2_conv3x3_align_corners_nchw,
)
from diffusionmodel_tpu_torch.ops.resize import (
    upsample_bilinear_align_corners_taps,
    upsample_bilinear_align_corners_nchw,
)
from diffusionmodel_tpu_torch.parallel.spatial import is_slab
from diffusionmodel_tpu_torch.parallel.tensor import full_weight

_F32 = torch.float32


def compute_dtype(name: str) -> torch.dtype:
    """``model.dtype`` as the JAX factory maps it: ``"bfloat16"`` is
    bfloat16, anything else float32."""
    return torch.bfloat16 if name == "bfloat16" else _F32


def div_scalar(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x / s`` with ``s`` rounded to x's dtype first, as JAX rounds a
    weakly typed Python scalar (PyTorch would divide a bf16 tensor by the
    float32 ``s`` and round once)."""
    if x.dtype == _F32:
        return x / s
    return x / torch.tensor(s, dtype=x.dtype)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Logistic sigmoid. Below float32 it is ``1 / (1 + exp(-x))`` with
    each step rounded to x's dtype, as XLA expands ``jax.nn.sigmoid``."""
    if x.dtype == _F32:
        return torch.sigmoid(x)
    one = torch.tensor(1.0, dtype=x.dtype)
    return one / (one + torch.exp(-x))


class GELU(nn.Module):
    """``nn.GELU()`` through :func:`gelu` (no parameters, so the
    ``state_dict`` is the same)."""

    def forward(self, x):
        return gelu(x)


def gn_groups(channels: int, preferred: int = 8) -> int:
    """Largest divisor of ``channels`` that is <= preferred."""
    g = max(1, min(preferred, channels))
    while channels % g != 0:
        g -= 1
    return g


def channels_last(x: torch.Tensor) -> torch.Tensor:
    """``x`` in channels_last memory; no copy when it already is."""
    return x.contiguous(memory_format=torch.channels_last)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW tensor -> contiguous NHWC view of the same channels_last memory."""
    return channels_last(x).permute(0, 2, 3, 1)


class _OutputBlocks:
    """The forward of a layer whose weight may hold a block of its output
    channels (``model_shard``, a ``parallel.tensor.ModelShard``): without
    one, ``_product`` with the bias; with one, this process's channels
    (its input's gradient summed over 'model'), gathered whole, then the
    bias added to the whole map. ``_out_dim``: the output's channel dim
    (1: NCHW; -1: a dense layer's features)."""

    model_shard = None
    _out_dim = 1

    def forward(self, x):
        tp = self.model_shard
        if tp is None:
            return self._product(x, self.bias)
        y = self._product(tp.enter(x), None)
        return add_bias(tp.gather(y, self._out_dim % y.dim()), self.bias,
                        self._out_dim)


class Conv2d(_OutputBlocks, nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype`` (flax's ``nn.Conv``
    with ``dtype``): input and weight cast at use, the product rounded,
    then the bias added in ``compute_dtype``. Without gradients a bf16
    convolution runs one sample at a time (``kernels.per_sample_conv``:
    cuDNN would otherwise let a sample's result depend on its batch
    position). With a ``model_shard`` the weight is this process's block
    of output channels: the layer computes those, gathers the whole map
    over 'model' and adds the bias to it (``parallel.tensor``)."""

    spatial = None  # a parallel.spatial.SpatialGroup on a sharded forward

    def __init__(self, *args, compute_dtype: torch.dtype = _F32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def _product(self, x, bias):
        if is_slab(self.spatial, x):
            return self._slab_forward(x, bias)
        dt = self.compute_dtype
        if dt == _F32:
            return self._conv_forward(x, self.weight, bias)
        w = self.weight.to(dt)
        y = per_sample_conv(lambda a: self._conv_forward(a, w, None),
                            x.to(dt))
        return add_bias(y, bias, 1)

    def _slab_forward(self, x, bias):
        """This slab's rows of the convolution of the whole map: the slab
        with ``pad`` halo rows above and ``kernel - stride - pad`` below,
        convolved without padding along H (3x3 pad 1: one each side; the
        4x4 stride-2 downsample: one each side, from an even row; 1x1:
        none)."""
        k, st, p = self.kernel_size[0], self.stride[0], self.padding[0]
        h = x.shape[2]
        if st > 1 and h % st:
            raise ValueError(f"a stride-{st} convolution on a slab of {h} "
                             f"rows: the slabs must hold a multiple of {st}")
        xh = self.spatial.halo(x, p, k - st - p)
        pad, dt = (0, self.padding[1]), self.compute_dtype
        if dt == _F32:
            return F.conv2d(xh, self.weight, bias, self.stride, pad,
                            self.dilation, self.groups)
        w = self.weight.to(dt)
        y = per_sample_conv(lambda a: F.conv2d(
            a, w, None, self.stride, pad, self.dilation, self.groups),
            xh.to(dt))
        return add_bias(y, bias, 1)


def add_bias(y: torch.Tensor, bias: Optional[torch.Tensor], dim: int
             ) -> torch.Tensor:
    """``y`` plus ``bias`` along ``dim`` (1: NCHW channels; -1: a dense
    layer's features), the bias cast to y's dtype (flax adds it in the
    compute dtype)."""
    if bias is None:
        return y
    b = bias.to(y.dtype)
    return y + (b[:, None, None] if dim == 1 else b)


class ConvTranspose2d(_OutputBlocks, nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` computing in ``compute_dtype``, as
    :class:`Conv2d` (its ``model_shard`` splits the weight's dim 1, the
    output channels)."""

    def __init__(self, *args, compute_dtype: torch.dtype = _F32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def _product(self, x, bias):
        dt = self.compute_dtype
        if dt == _F32:
            return F.conv_transpose2d(x, self.weight, bias, self.stride,
                                      self.padding, self.output_padding,
                                      self.groups, self.dilation)
        y = F.conv_transpose2d(x.to(dt), self.weight.to(dt), None,
                               self.stride, self.padding,
                               self.output_padding, self.groups,
                               self.dilation)
        return add_bias(y, bias, 1)


class Linear(_OutputBlocks, nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` (flax's ``nn.Dense``
    with ``dtype``): the product rounded, then the bias added; on the
    'model' axis as :class:`Conv2d`."""

    _out_dim = -1

    def __init__(self, *args, compute_dtype: torch.dtype = _F32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def _product(self, x, bias):
        dt = self.compute_dtype
        if dt == _F32:
            return F.linear(x, self.weight, bias)
        return add_bias(F.linear(x.to(dt), self.weight.to(dt)), bias, -1)


class GroupNorm(nn.GroupNorm):
    """GroupNorm whose output stays channels_last, followed by ``act``
    (None, "gelu" or "relu"; parameterless, so the ``state_dict`` is
    nn.GroupNorm's). ``eps`` is PyTorch's 1e-5 by default (the ContextUnet
    reference); flax's GroupNorm, which the latent-diffusion modules
    mirror, uses 1e-6. With a bf16 ``compute_dtype`` the statistics and the
    affine run in float32 and the output is rounded once, as flax's
    GroupNorm at ``dtype=bfloat16``; ``act`` then runs in bf16.

    With ``use_pallas``, a bf16 map on the card without gradients
    (inference), whole and not a slab, of a shape the kernel takes
    (``kernels.group_norm.takes``) takes the CUDA kernel
    (``kernels.group_norm.group_norm_act``: the norm and ``act`` in one
    launch). Everything else (no ``use_pallas``, training, float32, slabs,
    the CPU, shapes past the kernel's limits) runs
    ``F.group_norm`` (``kernels.group_norm.group_norm_f32``: per sample on
    the CPU), then ``act``: the same operations as a GroupNorm followed by
    the activation's module, so autograd and a checkpointed recompute see
    the same graph."""

    spatial = None  # a parallel.spatial.SpatialGroup on a sharded forward
    precast = False  # the affine rounded to bf16 (``precast_params``)

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 compute_dtype: torch.dtype = _F32,
                 act: Optional[str] = None, use_pallas: bool = False):
        super().__init__(num_groups, num_channels, eps=eps)
        self.compute_dtype = compute_dtype
        self.act = act
        self.use_pallas = use_pallas

    def _takes_kernel(self, x) -> bool:
        b, c, h, w = x.shape
        return (self.use_pallas and on_card(x) and x.dtype == torch.bfloat16
                and self.compute_dtype == torch.bfloat16
                and not torch.is_grad_enabled()
                and not is_slab(self.spatial, x)
                and takes(b, h, w, c, self.num_groups))

    def forward(self, x):
        dt = self.compute_dtype
        w, b = _affine(self)
        if self._takes_kernel(x):
            return group_norm_act(to_nhwc(x), w, b, self.num_groups,
                                  self.eps, self.act).permute(0, 3, 1, 2)
        if dt != _F32:
            x = x.float()
        if is_slab(self.spatial, x):
            y = self._slab_forward(x, w, b)
        else:
            y = group_norm_f32(x, w, b, self.num_groups, self.eps)
        return activation(y if dt == _F32 else y.to(dt), self.act)

    def _slab_forward(self, x, weight, bias):
        """GroupNorm of the whole map from this slab (float32 x): per
        sample and group, the sums of x and x^2 over the slab in float64,
        summed over the slabs (one all_reduce), the variance their mean
        of squares less the squared mean (float64 loses nothing to the
        cancellation)."""
        b, c = x.shape[:2]
        g = self.num_groups
        xd = x.double().reshape(b, g, -1)
        stats = self.spatial.all_reduce(
            torch.stack([xd.sum(dim=2), (xd * xd).sum(dim=2)]))
        n = xd.shape[2] * self.spatial.shards
        mean = stats[0] / n
        var = torch.clamp(stats[1] / n - mean * mean, min=0.0)
        invstd = torch.rsqrt(var + self.eps).float()
        mean = mean.float()
        shape = (b, c, 1, 1)
        mean_c = mean.repeat_interleave(c // g, dim=1).reshape(shape)
        inv_c = invstd.repeat_interleave(c // g, dim=1).reshape(shape)
        y = (x - mean_c) * inv_c
        return channels_last(y * weight[:, None, None]
                             + bias[:, None, None])


def _affine(norm: nn.Module) -> tuple:
    """A norm's (weight, bias): float32, rounded to bf16 first under
    :func:`precast_params`, as the JAX package's bf16 sampler casts the
    parameters (its norms compute in float32 with the bf16 values)."""
    w, b = norm.weight, norm.bias
    if norm.precast:
        w, b = (t.to(torch.bfloat16).float() for t in (w, b))
    return w, b


@contextlib.contextmanager
def precast_params(model: nn.Module):
    """Inside the block, ``model`` computes as the JAX package's bf16
    sampler does (``trainer.make_sampler``'s ``_precast``: every float32
    parameter cast to bf16 once per call). Where a layer casts its
    parameters at use that changes nothing; it changes the layers that use
    float32 parameters as they are: the norms' affine is rounded to bf16
    (:class:`GroupNorm`, :class:`BatchNorm2d` in eval mode), and
    CoordAttn's plain path takes its four scalars in bf16, so its mix
    and weighting round to bf16 instead of promoting to float32. For a
    model computing in bf16 only (JAX leaves a float32 model as it is)."""
    mods = [m for m in model.modules() if hasattr(type(m), "precast")]
    for m in mods:
        m.precast = True
    try:
        yield
    finally:
        for m in mods:
            m.precast = False


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode batch normalisation of x [N,C,H,W] (float32) with the
    statistics of the whole batch across ``group``'s processes, as
    ``SyncBatchNorm`` computes them: one ``all_reduce`` of (sum, sum of
    squares, count) in the forward, one of (sum dy, sum dy*x_hat) in the
    backward, so each process's input gradient holds every process's
    share of the statistics' gradient. The weight and bias gradients are
    this process's own (the train step averages them with the rest).
    The sums are float64, so the variance (the mean of squares less the
    squared mean) loses nothing to cancellation. Returns (y, mean, biased
    var); the statistics carry no gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        c = x.shape[1]
        xd = x.double()
        stats = torch.cat([xd.sum(dim=(0, 2, 3)),
                           (xd * xd).sum(dim=(0, 2, 3)),
                           xd.new_full((1,), x.numel() // c)])
        del xd
        dist.all_reduce(stats, group=group)
        n = stats[-1]
        mean = stats[:c] / n
        var = torch.clamp(stats[c:2 * c] / n - mean * mean, min=0.0).float()
        mean, n = mean.float(), n.float()
        invstd = torch.rsqrt(var + eps)
        x_hat = (x - mean[:, None, None]) * invstd[:, None, None]
        y = x_hat * weight[:, None, None] + bias[:, None, None]
        ctx.save_for_backward(x_hat, weight, invstd, n)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x_hat, weight, invstd, n = ctx.saved_tensors
        c = dy.shape[1]
        local = torch.cat([dy.sum(dim=(0, 2, 3)),
                           (dy * x_hat).sum(dim=(0, 2, 3))])
        sums = local.clone()
        dist.all_reduce(sums, group=ctx.group)
        dx = (dy - (sums[:c] / n)[:, None, None]
              - x_hat * (sums[c:] / n)[:, None, None]) \
            * (invstd * weight)[:, None, None]
        return dx, local[c:], local[:c], None, None


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm (eps 1e-5, torch momentum 0.1 = flax 0.9) whose output
    stays channels_last.

    In train mode the running statistics follow flax's ``nn.BatchNorm``,
    not PyTorch's: ``running_var`` moves toward the *biased* batch variance
    (the one the batch is normalised with), where ``nn.BatchNorm2d`` would
    take the unbiased one, n/(n-1) larger. A forward run again inside a
    backward pass (``torch.utils.checkpoint``'s recompute) leaves them
    alone, so a rematerialised step updates them once, as ``jax.checkpoint``
    does. Eval mode is PyTorch's. With a bf16 ``compute_dtype`` it
    normalises in float32 and rounds the output, as flax does.

    Under :func:`global_batch_stats` (the data-parallel train step), train
    mode normalises with the statistics of the global batch across the
    data group (``_GlobalBatchNorm``), as flax's BatchNorm does over the
    logical batch under GSPMD, and the running statistics follow them."""

    precast = False  # the affine rounded to bf16 (``precast_params``)

    def __init__(self, num_features: int, compute_dtype: torch.dtype = _F32):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.compute_dtype = compute_dtype
        self.group = None

    def forward(self, x):
        dt = self.compute_dtype
        if dt != _F32:
            return self._forward_f32(x.float()).to(dt)
        return self._forward_f32(x)

    def _forward_f32(self, x):
        if not self.training:
            w, b = _affine(self)
            return channels_last(F.batch_norm(
                x, self.running_mean, self.running_var, w, b, False, 0.0,
                self.eps))
        if self.group is not None:
            out, mean, var = _GlobalBatchNorm.apply(
                x, self.weight, self.bias, self.eps, self.group)
        else:
            out = F.batch_norm(x, None, None, self.weight, self.bias, True,
                               0.0, self.eps)
        if torch._C._current_graph_task_id() == -1:  # not in a backward
            with torch.no_grad():
                if self.group is None:
                    xf = x.detach().float()
                    mean = xf.mean(dim=(0, 2, 3))
                    var = xf.var(dim=(0, 2, 3), unbiased=False)
                self.running_mean.mul_(1.0 - self.momentum).add_(
                    mean, alpha=self.momentum)
                self.running_var.mul_(1.0 - self.momentum).add_(
                    var, alpha=self.momentum)
                self.num_batches_tracked.add_(1)
        return channels_last(out)


@contextlib.contextmanager
def global_batch_stats(model: nn.Module, group):
    """Inside the block, every :class:`BatchNorm2d` of ``model`` takes its
    train-mode statistics over ``group`` (None: this process's batch)."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    for m in bns:
        m.group = group
    try:
        yield
    finally:
        for m in bns:
            m.group = None


def norm_layer(kind: str, channels: int, groups: int = 8,
               dtype: torch.dtype = _F32,
               use_pallas: bool = False) -> nn.Module:
    """The JAX package's ``Norm``: GroupNorm(gn_groups(C, groups)) by
    default, BatchNorm for reference parity (SURVEY Q2)."""
    if kind == "group":
        return GroupNorm(gn_groups(channels, groups), channels,
                         compute_dtype=dtype, use_pallas=use_pallas)
    if kind == "batch":
        return BatchNorm2d(channels, compute_dtype=dtype)
    raise ValueError(f"unknown norm kind {kind!r}")


def norm_act(kind: str, channels: int, act: str, dtype: torch.dtype = _F32,
             use_pallas: bool = False) -> tuple:
    """(norm, the activation's slot) for ``Sequential(..., norm, act)``: a
    GroupNorm applies ``act`` itself and leaves ``nn.Identity`` in the slot;
    a BatchNorm leaves it to the slot's GELU or ReLU module. Neither slot
    holds parameters, so the ``state_dict`` keys are the same either way."""
    norm = norm_layer(kind, channels, dtype=dtype, use_pallas=use_pallas)
    if isinstance(norm, GroupNorm):
        norm.act = act
        return norm, nn.Identity()
    return norm, (GELU() if act == "gelu" else nn.ReLU())


def conv(in_features: int, features: int, kernel: int, stride: int = 1,
         bias: bool = True, dtype: torch.dtype = _F32) -> Conv2d:
    """Conv2d with the JAX package's explicit padding rule."""
    pad = (kernel - 1) // 2 if kernel % 2 == 1 else max(kernel // 2 - 1, 0)
    return Conv2d(in_features, features, kernel, stride=stride,
                  padding=pad, bias=bias, compute_dtype=dtype)


class EmbedFC(nn.Module):
    """Linear -> GELU -> Linear over a flattened input (new_scripy.py:255-268)."""

    def __init__(self, input_dim: int, emb_dim: int,
                 dtype: torch.dtype = _F32):
        super().__init__()
        self.input_dim = input_dim
        self.model = nn.Sequential(
            Linear(input_dim, emb_dim, compute_dtype=dtype), GELU(),
            Linear(emb_dim, emb_dim, compute_dtype=dtype))

    def forward(self, x):
        return self.model(x.reshape(-1, self.input_dim))


def se_module_plain(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                    dtype: torch.dtype = _F32, spatial=None) -> torch.Tensor:
    """The SE block's own path (the JAX module's XLA lines, not the
    kernel's function): the mean taken in float32 and rounded to
    ``dtype``, both products and the gate in ``dtype`` with the weights
    cast, then ``x * gate``. x: [B,H,W,C]; w1: [C,R]; w2: [R,C]. One
    product per sample. At float32 it computes what the kernel's twin
    ``kernels.se_block.se_block_plain`` computes. With ``spatial`` (a
    ``SpatialGroup``) x is a slab: its float32 sums are summed over the
    slabs before the division."""
    if spatial is None:
        y = x.float().mean(dim=(1, 2))
    else:
        y = spatial.all_reduce(x.float().sum(dim=(1, 2))) / (
            x.shape[1] * spatial.shards * x.shape[2])
    y = y.to(dtype)
    y = gelu(per_sample_matmul(y, w1.to(dtype)))
    y = sigmoid(per_sample_matmul(y, w2.to(dtype)))
    return x * y[:, None, None, :]


class SEBlock(nn.Module):
    """Squeeze-excitation (new_scripy.py:143-158): global mean ->
    Linear(C->C/r, no bias) -> GELU -> Linear(->C, no bias) -> sigmoid scale.

    With ``use_pallas`` in eval mode the block runs through
    :func:`kernels.se_block.se_block` (the CUDA kernel for CUDA tensors,
    its twin for CPU ones: float32 pooling and MLP, the gate rounded to
    x's dtype); otherwise through :func:`se_module_plain` in ``dtype``.
    The two coincide at float32 and differ in bf16, as in the JAX package.
    ``fc`` keeps the reference's layers for their ``state_dict`` names;
    both paths compute with their weights, one product per sample. The
    kernel reads ``fc[0].weight`` and ``fc[2].weight`` in place (it takes
    ``w1``/``w2`` as their transposed views), so an eval call launches the
    one kernel and no copy. A layer cut over 'model' is gathered whole
    first (``parallel.tensor.full_weight``), as GSPMD gathers a Pallas
    call's sharded operands: the block then runs replicated."""

    spatial = None  # a parallel.spatial.SpatialGroup on a sharded forward

    def __init__(self, channels: int, reduction: int = 16,
                 use_pallas: bool = False, dtype: torch.dtype = _F32):
        super().__init__()
        red = max(1, channels // reduction)
        self.use_pallas = use_pallas
        self.dtype = dtype
        self.fc = nn.Sequential(Linear(channels, red, bias=False),
                                GELU(),
                                Linear(red, channels, bias=False),
                                nn.Sigmoid())

    def forward(self, x):
        w1, w2 = full_weight(self.fc[0]).t(), full_weight(self.fc[2]).t()
        sp = self.spatial if is_slab(self.spatial, x) else None
        if self.use_pallas and not self.training:
            out = (se_block(to_nhwc(x), w1, w2) if sp is None
                   else se_block_slab(to_nhwc(x), w1, w2, sp))
        else:
            out = se_module_plain(to_nhwc(x), w1, w2, self.dtype, sp)
        return out.permute(0, 3, 1, 2)


class LocalEnhancer(nn.Module):
    """High-attention region enhancement (new_scripy.py:161-174):
    ``x + conv3x3-GN(8)-GELU-conv3x3(x) * (mask > high_thresh)``.

    Q3: takes the spatial attention mask [B, H, W]; with ``mask`` None
    (sampling) the block is the identity, and the branch is not computed."""

    def __init__(self, channels: int, high_thresh: float = 1.2,
                 act: str = "gelu", dtype: torch.dtype = _F32,
                 use_pallas: bool = False):
        super().__init__()
        self.high_thresh = high_thresh
        self.conv = nn.Sequential(
            conv(channels, channels, 3, dtype=dtype),
            *norm_act("group", channels, act, dtype, use_pallas),
            conv(channels, channels, 3, dtype=dtype))

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        if mask is None:
            return x
        gate = (mask > self.high_thresh).to(x.dtype)[:, None, :, :]
        return x + self.conv(x) * gate


class ResConvBlock(nn.Module):
    """2x (conv3x3 + Norm + GELU) with optional SE + residual /1.414
    (new_scripy.py:176-209)."""

    def __init__(self, in_ch: int, out_ch: int, is_res: bool = False,
                 use_se: bool = True, norm: str = "group",
                 attn_reduction: int = 16, use_pallas: bool = False,
                 dtype: torch.dtype = _F32):
        super().__init__()
        self.is_res = is_res
        self.same_channels = in_ch == out_ch
        self.conv1 = nn.Sequential(
            conv(in_ch, out_ch, 3, dtype=dtype),
            *norm_act(norm, out_ch, "gelu", dtype, use_pallas))
        self.conv2 = nn.Sequential(
            conv(out_ch, out_ch, 3, dtype=dtype),
            *norm_act(norm, out_ch, "gelu", dtype, use_pallas))
        self.se = (SEBlock(out_ch, attn_reduction, use_pallas, dtype)
                   if is_res and use_se else None)

    def forward(self, x):
        x1 = self.conv1(x)
        x2 = self.conv2(x1)
        if not self.is_res:
            return x2
        if self.se is not None:
            x2 = self.se(x2)
        out = (x + x2) if self.same_channels else (x1 + x2)
        return div_scalar(out, 1.414)


class UnetDown(nn.Module):
    """Down block (new_scripy.py:211-235): 1x1 compress (C/4) -> 1x1 adjust
    -> conv3x3 -> ResConvBlock(res) -> 4x4 stride-2 downsample."""

    def __init__(self, in_ch: int, out_ch: int, compress_ratio: int = 4,
                 use_se: bool = True, norm: str = "group",
                 attn_reduction: int = 16, use_pallas: bool = False,
                 dtype: torch.dtype = _F32):
        super().__init__()
        cc = in_ch // compress_ratio
        self.channel_compress = nn.Sequential(
            conv(in_ch, cc, 1, dtype=dtype),
            *norm_act(norm, cc, "gelu", dtype, use_pallas))
        self.ch_adjust = conv(cc, out_ch, 1, dtype=dtype)
        self.down = nn.Sequential(
            conv(out_ch, out_ch, 3, dtype=dtype),
            *norm_act(norm, out_ch, "gelu", dtype, use_pallas),
            ResConvBlock(out_ch, out_ch, is_res=True, use_se=use_se,
                         norm=norm, attn_reduction=attn_reduction,
                         use_pallas=use_pallas, dtype=dtype),
            conv(out_ch, out_ch, 4, stride=2, dtype=dtype))

    def forward(self, x):
        return self.down(self.ch_adjust(self.channel_compress(x)))


class UpsampleBilinear2x(nn.Module):
    """``nn.Upsample(scale_factor=2, mode='bilinear', align_corners=True)``.
    In the bf16 net (``dtype``) it runs in float32 with the JAX package's
    arithmetic (``ops.resize.upsample_bilinear_align_corners_taps``): JAX
    contracts the activations with float32 interpolation matrices, which
    promotes them to float32. The float32 net keeps PyTorch's upsample."""

    spatial = None  # a parallel.spatial.SpatialGroup on a sharded forward

    def __init__(self, dtype: torch.dtype = _F32):
        super().__init__()
        self.dtype = dtype

    def forward(self, x):
        if is_slab(self.spatial, x):
            # the output slab's taps reach one row past the slab each side
            sp = self.spatial
            return channels_last(upsample_bilinear_align_corners_taps(
                sp.halo(x, 1, 1), 2, rows=(sp.row0(x.shape[2]), x.shape[2],
                                           x.shape[2] * sp.shards)))
        if self.dtype == _F32:
            return upsample_bilinear_align_corners_nchw(x, 2)
        return channels_last(upsample_bilinear_align_corners_taps(x, 2))


class UnetUp(nn.Module):
    """Up block (new_scripy.py:237-253): cat(x, skip) -> bilinear x2
    (align_corners=True) -> conv3x3 -> 2x ResConvBlock.

    ``fused_upsample`` computes the same upsample + conv pair through
    :func:`ops.fused_upconv.up2_conv3x3_align_corners_nchw` (the conv at
    half the rows) in ``dtype``, on the same conv's parameters: the
    ``state_dict`` is the same with and without it."""

    def __init__(self, in_ch: int, out_ch: int, norm: str = "group",
                 dtype: torch.dtype = _F32, fused_upsample: bool = False,
                 use_pallas: bool = False):
        super().__init__()
        self.dtype = dtype
        self.fused_upsample = fused_upsample
        res = dict(norm=norm, use_pallas=use_pallas, dtype=dtype)
        self.model = nn.Sequential(
            nn.Sequential(UpsampleBilinear2x(dtype),
                          conv(in_ch, out_ch, 3, dtype=dtype)),
            ResConvBlock(out_ch, out_ch, **res),
            ResConvBlock(out_ch, out_ch, **res))

    spatial = None  # a parallel.spatial.SpatialGroup on a sharded forward

    def forward(self, x, skip):
        x = torch.cat([x, skip], dim=1)
        if not self.fused_upsample:
            return self.model(x)
        dt, c = self.dtype, self.model[0][1]
        tp = c.model_shard  # a block of Cout: the bias after the gather
        bias = c.bias.to(dt) if tp is None else None
        if tp is not None:
            x = tp.enter(x)
        if is_slab(self.spatial, x):
            sp = self.spatial
            x = up2_conv3x3_align_corners_nchw(
                sp.halo(x, 1, 1).to(dt), c.weight.to(dt), bias,
                rows=(sp.row0(x.shape[2]), x.shape[2],
                      x.shape[2] * sp.shards))
        else:
            x = up2_conv3x3_align_corners_nchw(x.to(dt), c.weight.to(dt),
                                               bias)
        if tp is not None:
            x = add_bias(tp.gather(x, 1), c.bias, 1)
        return self.model[2](self.model[1](x))
