"""Coordinate attention: the hand-written CUDA kernel, its plain twin and
the weight packing.

Counterpart of ``diffusionmodel_tpu/kernels/coord_attn.py``. The kernel
(``csrc/coord_attn.cu``) replaces the Pallas kernel reached from
``coord_attn_fused``; the source notes its design and what bounds it.

:func:`coord_attn` takes the kernel for a CUDA tensor and the plain
PyTorch twin :func:`coord_attn_plain` for a CPU tensor, and raises for
anything the kernel does not take. It never falls back from CUDA to the
twin.

The kernel runs in three launches (pool, bottleneck, apply);
:func:`launch_plan` sizes them, and :func:`coord_attn_staged` follows
their stages and tiles in plain torch, for the tests and as documentation.

x is float32 or bfloat16; the packed weights are float32 either way, and
both the kernel and the twin compute in float32 inside and round the
output once to x's dtype, as the Pallas kernel does.

Norm kinds, as in the JAX package: ``"group"`` computes GroupNorm
statistics of the pooled [L, R] tensors per sample; ``"affine"`` is an
inference BatchNorm folded to scale/shift.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from dataclasses import dataclass, fields
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from diffusionmodel_tpu_torch.kernels import _build, per_sample_matmul
from diffusionmodel_tpu_torch.parallel.tensor import full_weight

# The pooling pass reads x in chunks of 8 vectors of 16 bytes (32 float32
# or 64 bf16 channels), as a tile of at most 16 rows per block; a warp
# reads 4 columns of a row, a block at most 8 warps, and a lane keeps at
# most 8 columns' sums. Its static shared memory holds the rows' per-warp
# sums (twice as many floats for bf16).
CHUNK_CHANNELS = 32
POOL_ROWS = 16
POOL_WARPS = 8
POOL_SMEM = POOL_ROWS * POOL_WARPS * 8 * 16
MAX_SIDE = POOL_WARPS * 4 * 8
# The bottleneck pass: blocks of 16 rows x 32 outputs of R x a k-slice of
# at most BN_SPLIT_CHUNKS chunks of 64 channels, 256 threads. A chunk is
# staged by cp.async as T [16, 68] tiles of means (the T row tiles' column
# sums for the W direction) and a [64, 32] tile of W1, in a ring of 2 to
# BN_MAX_STAGES buffers. The last block of a (sample, direction) holds its
# y [L, R], the norm, the GroupNorm statistics and the cross-mix weights
# [R+1, R]. Its one static shared value is the last-block flag.
BN_ROWS, BN_COLS, BN_CHUNK, BN_SPLIT_CHUNKS = 16, 32, 64, 6
BN_STATIC_SMEM = 4
BN_MAX_STAGES = 7
BN_BLOCKS_PER_SM = 3  # __launch_bounds__(256, 3): at most 80 registers
BN_SMEM_PER_SM = 225 * 1024
SMS = 132  # H100 SXM: sizes the ring for the blocks per SM the grid needs
# The apply pass: blocks of 16 rows x 32 channels (kApplyCh), 256 threads.
APPLY_ROWS = 16
APPLY_CHANNELS = 32
THREADS = 256
# Shared memory a Hopper block can take; the kernels ask for 1 KB less.
MAX_SHARED_BYTES = 232448
MAX_DYNAMIC_SMEM = MAX_SHARED_BYTES - 1024


class PassPlan(NamedTuple):
    grid: Tuple[int, int, int]
    block: int
    smem: int  # bytes of shared memory per block (static + dynamic)


class LaunchPlan(NamedTuple):
    pool: PassPlan
    bottleneck: PassPlan
    apply: PassPlan
    pool_rows: int
    n_tiles: int  # row tiles of the pooling pass: T in cp [B, T, L, C]
    n_splits: int  # k-slices of the bottleneck's product
    split_chunks: int  # chunks of 64 channels per k-slice
    n_stages: int  # the bottleneck's ring of staged chunks
    apply_rows: int
    scratch_bytes: int  # rmean, cp, y, yn, yx and the k-slices' partials
    partial_bytes: int  # cp, the column sums per row tile
    counters: int  # per (sample, direction), then per output tile


def _pool_plan(b: int, rows: int, l: int, c: int, elem_bytes: int):
    """The pooling pass over ``rows`` rows of ``l`` columns: (plan,
    rows per tile, row tiles)."""
    per_chunk = CHUNK_CHANNELS * 4 // elem_bytes
    chunks = -(-c // per_chunk)
    pool_rows = min(POOL_ROWS, rows)
    n_tiles = -(-rows // pool_rows)
    pool_warps = min(POOL_WARPS, -(-l // 4))
    return (PassPlan((chunks, n_tiles, b), 32 * pool_warps,
                     POOL_SMEM * per_chunk // CHUNK_CHANNELS),
            pool_rows, n_tiles)


def _bottleneck_plan(b: int, l: int, c: int, r: int, n_tiles: int,
                     groups: int):
    """The bottleneck over a map of side ``l`` whose column means arrive
    as ``n_tiles`` row tiles' sums: (plan, k-slices, chunks per slice,
    ring depth)."""
    k_chunks = -(-c // BN_CHUNK)
    n_splits = -(-k_chunks // BN_SPLIT_CHUNKS)
    split_chunks = -(-k_chunks // n_splits)
    n_rt, n_jt = -(-l // BN_ROWS), -(-r // BN_COLS)
    # ring depth: the whole slice where shared memory allows the blocks
    # per SM the grid needs (at most 3, the register bound), else 2
    stage = 4 * (n_tiles * BN_ROWS * (BN_CHUNK + 4) + BN_CHUNK * BN_COLS)
    per_sm = min(BN_BLOCKS_PER_SM, -(-(n_jt * n_splits * n_rt * 2 * b) // SMS))
    n_stages = max(2, min(split_chunks, BN_MAX_STAGES,
                          BN_SMEM_PER_SM // per_sm // stage))
    ring = n_stages * stage // 4
    mix = (l * r + 2 * r + 2 * groups + 3) // 4 * 4 + (r + 1) * r
    return (PassPlan((n_jt * n_splits, n_rt, 2 * b), THREADS,
                     4 * max(ring, mix) + BN_STATIC_SMEM),
            n_splits, split_chunks, n_stages)


def _apply_plan(b: int, rows: int, l: int, c: int, r: int):
    """The apply pass over ``rows`` rows of a map of side ``l``: (plan,
    rows per tile)."""
    apply_rows = min(APPLY_ROWS, rows)
    rp = -(-r // 4) * 4
    gate_rows = apply_rows + l  # the tile's rows, then all L columns
    return (PassPlan((-(-c // APPLY_CHANNELS), -(-rows // apply_rows), b),
                     THREADS, 4 * (gate_rows * (rp + max(rp, APPLY_CHANNELS))
                                   + 2 * rp * APPLY_CHANNELS)),
            apply_rows)


def _partials_floats(b: int, l: int, r: int, n_splits: int) -> int:
    """The bottleneck's k-slice partials, when it has more than one."""
    tiles = 2 * b * -(-l // BN_ROWS) * -(-r // BN_COLS)
    return tiles * n_splits * BN_ROWS * BN_COLS if n_splits > 1 else 0


@functools.lru_cache(maxsize=256)
def launch_plan(b: int, l: int, c: int, r: int, norm_kind: str = "group",
                groups: int = 1, elem_bytes: int = 4) -> LaunchPlan:
    """Grid, block and shared memory of each pass, and the scratch, for x
    [b, l, l, c] of ``elem_bytes``-byte elements (4 float32, 2 bf16) and
    R = r (``groups`` 1 for the affine norm). Plain Python, so the CPU
    tests check it; the wrapper hands its numbers to the C entry point.
    Tiles depend on l, c and r, never on b: a sample's sums do not depend
    on its batch. Only the pooling pass's chunks depend on the type."""
    pool, pool_rows, n_tiles = _pool_plan(b, l, l, c, elem_bytes)
    bottleneck, n_splits, split_chunks, n_stages = _bottleneck_plan(
        b, l, c, r, n_tiles, groups)
    apply, apply_rows = _apply_plan(b, l, l, c, r)
    yp = _partials_floats(b, l, r, n_splits)
    partial = 4 * b * n_tiles * l * c
    return LaunchPlan(
        pool, bottleneck, apply, pool_rows, n_tiles, n_splits, split_chunks,
        n_stages, apply_rows,
        scratch_bytes=4 * (b * l * c + 6 * b * l * r + yp) + partial,
        partial_bytes=partial,
        counters=2 * b + 2 * b * -(-l // BN_ROWS) * -(-r // BN_COLS))


class SlabPlan(NamedTuple):
    pool: PassPlan
    bottleneck: PassPlan
    apply: PassPlan
    pool_rows: int
    n_tiles: int  # the slab's row tiles: T in cp [B, T, L, C]
    n_splits: int
    split_chunks: int
    n_stages: int
    apply_rows: int
    cp_bytes: int  # the pooling pass's per-tile column sums
    scratch_bytes: int  # the bottleneck's y and k-slice partials
    counters: int


@functools.lru_cache(maxsize=256)
def slab_plan(b: int, h: int, l: int, c: int, r: int,
              norm_kind: str = "group", groups: int = 1,
              elem_bytes: int = 4) -> SlabPlan:
    """The slab form's launches for a slab x [b, h, l, c] of a map of side
    ``l``: the pooling and apply passes over the slab's h rows, the
    bottleneck over the whole map's pooled terms, its column sums arriving
    already folded (one row tile)."""
    pool, pool_rows, n_tiles = _pool_plan(b, h, l, c, elem_bytes)
    bottleneck, n_splits, split_chunks, n_stages = _bottleneck_plan(
        b, l, c, r, 1, groups)
    apply, apply_rows = _apply_plan(b, h, l, c, r)
    return SlabPlan(
        pool, bottleneck, apply, pool_rows, n_tiles, n_splits, split_chunks,
        n_stages, apply_rows, cp_bytes=4 * b * n_tiles * l * c,
        scratch_bytes=4 * (2 * b * l * r + _partials_floats(b, l, r,
                                                            n_splits)),
        counters=2 * b + 2 * b * -(-l // BN_ROWS) * -(-r // BN_COLS))


@dataclass
class CoordAttnWeights:
    """Flat, kernel-ready packing of CoordAttn parameters (float32):

    - ``w1h``, ``w1w`` [C+1, R]: 1x1 conv C->R kernels, bias as last row;
    - ``nh``, ``nw`` [2, R]: norm scale and shift (GroupNorm weight/bias,
      or BatchNorm folded with its running statistics);
    - ``wmix`` [2(R+1), R]: the h2w projection then the w2h projection,
      each with its bias row;
    - ``wout`` [2R, C]: the conv_h then conv_w kernels;
    - ``bout`` [2, C]: their biases;
    - ``scal`` [4] (or the JAX package's [1, 128]): sigmoid(gamma_h),
      sigmoid(gamma_w), alpha-hat, beta-hat.
    """

    w1h: torch.Tensor
    w1w: torch.Tensor
    nh: torch.Tensor
    nw: torch.Tensor
    wmix: torch.Tensor
    wout: torch.Tensor
    bout: torch.Tensor
    scal: torch.Tensor

    @classmethod
    def from_module(cls, mod, norm_kind: str = "group") -> "CoordAttnWeights":
        """Pack the parameters of an ``nn.coord_attn.CoordAttn``."""

        def kern(conv):  # torch [O, I, 1, 1] -> [I, O], whole over 'model'
            return full_weight(conv).reshape(conv.out_channels,
                                             conv.in_channels).t()

        def fold(conv):
            return torch.cat([kern(conv), conv.bias[None, :]], dim=0)

        if norm_kind == "affine":
            def norm(bn):
                inv = bn.weight / torch.sqrt(bn.running_var + bn.eps)
                return torch.stack([inv, bn.bias - bn.running_mean * inv])
        elif norm_kind == "group":
            def norm(gn):
                return torch.stack([gn.weight, gn.bias])
        else:
            raise ValueError(f"unknown norm_kind {norm_kind!r}")

        gh, gw, al, be = (torch.sigmoid(p.reshape(())) for p in (
            mod.gamma_h, mod.gamma_w, mod.alpha, mod.beta))
        ssum = al + be + 1e-8
        return cls(
            w1h=fold(mod.conv1_h), w1w=fold(mod.conv1_w),
            nh=norm(mod.bn1_h), nw=norm(mod.bn1_w),
            wmix=torch.cat([fold(mod.h2w_proj), fold(mod.w2h_proj)], dim=0),
            wout=torch.cat([kern(mod.conv_h), kern(mod.conv_w)], dim=0),
            bout=torch.stack([mod.conv_h.bias, mod.conv_w.bias]),
            scal=torch.stack([gh, gw, al / ssum, be / ssum]),
        )


def _group_norm(v: torch.Tensor, groups: int, scale: torch.Tensor,
                bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """GN over [B, L, R]: statistics per sample and group over (L, R/g)."""
    b, l, r = v.shape
    vg = v.reshape(b, l, groups, r // groups)
    mean = vg.mean(dim=(1, 3), keepdim=True)
    var = ((vg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    vn = ((vg - mean) * torch.rsqrt(var + eps)).reshape(b, l, r)
    return vn * scale + bias


def coord_attn_plain(x: torch.Tensor, wts: CoordAttnWeights,
                     norm_kind: str = "group", gn_groups: int = 4
                     ) -> torch.Tensor:
    """Plain twin of the kernel (the counterpart of ``coord_attn_xla``).
    x: [B,H,W,C] with H == W."""
    xf = x.float()
    xh = xf.mean(dim=2)  # [B, H, C]
    xw = xf.mean(dim=1)  # [B, W, C]
    r = wts.w1h.shape[-1]
    mm = per_sample_matmul
    xh1 = mm(xh, wts.w1h[:-1]) + wts.w1h[-1]
    xw1 = mm(xw, wts.w1w[:-1]) + wts.w1w[-1]
    if norm_kind == "affine":
        xh1 = xh1 * wts.nh[0] + wts.nh[1]
        xw1 = xw1 * wts.nw[0] + wts.nw[1]
    elif norm_kind == "group":
        xh1 = _group_norm(xh1, gn_groups, wts.nh[0], wts.nh[1])
        xw1 = _group_norm(xw1, gn_groups, wts.nw[0], wts.nw[1])
    else:
        raise ValueError(f"unknown norm_kind {norm_kind!r}")
    xh1 = F.gelu(xh1)
    xw1 = F.gelu(xw1)
    h2w = mm(xh1, wts.wmix[:r]) + wts.wmix[r]
    w2h = mm(xw1, wts.wmix[r + 1:2 * r + 1]) + wts.wmix[2 * r + 1]
    s = wts.scal.reshape(-1)
    xh2 = xh1 + s[0] * w2h
    xw2 = xw1 + s[1] * h2w
    a_h = torch.sigmoid(mm(xh2, wts.wout[:r]) + wts.bout[0])
    a_w = torch.sigmoid(mm(xw2, wts.wout[r:]) + wts.bout[1])
    attn = s[2] * a_h[:, :, None, :] + s[3] * a_w[:, None, :, :]
    return (xf * attn).to(x.dtype)


def coord_attn_staged(x: torch.Tensor, wts: CoordAttnWeights,
                      norm_kind: str = "group", gn_groups: int = 4
                      ) -> torch.Tensor:
    """The kernel's three passes in plain torch, stage by stage and tile by
    tile: row means and per-row-tile column sums (added in tile order),
    y = pooled @ W1 by k-slices of at most 6 chunks of 64 channels, each
    chunk split into four k-groups of 16 (k-groups, then slices, added in
    order, then the bias), GroupNorm statistics per sample and direction
    over [L, R/G] (mean, then centred squares), GELU -> yn and each
    direction's cross term yx = yn @ Wx + bx, then per (row tile,
    32-channel chunk) block z = yn + s * (the other direction's yx) and the
    gates. For tests and docs; the main path never calls it.
    x: [B, L, L, C]."""
    b, l, _, c = x.shape
    r = wts.w1h.shape[-1]
    plan = launch_plan(b, l, c, r, norm_kind, gn_groups)
    xf = x.float()
    s = wts.scal.reshape(-1)
    # pass 1
    mh = xf.sum(dim=2) / l
    parts = [xf[:, h:h + plan.pool_rows].sum(dim=1)
             for h in range(0, l, plan.pool_rows)]
    # pass 2: column means, then y by chunks and k-groups
    col = parts[0]
    for p in parts[1:]:
        col = col + p
    pooled = torch.stack([mh, col / l], dim=1)  # [B, 2, L, C]
    w1 = torch.stack([wts.w1h[:-1], wts.w1w[:-1]])  # [2, C, R]
    groups_k, step = 4, BN_CHUNK // 4
    slices = []
    span = plan.split_chunks * BN_CHUNK
    for k0 in range(0, c, span):
        acc = [torch.zeros((b, 2, l, r)) for _ in range(groups_k)]
        for c0 in range(k0, min(c, k0 + span), BN_CHUNK):
            for g in range(groups_k):
                sl = slice(c0 + g * step, min(c0 + (g + 1) * step, c))
                if sl.start < sl.stop:
                    acc[g] = acc[g] + torch.einsum(
                        "bdlc,dcr->bdlr", pooled[..., sl], w1[:, sl])
        slices.append(((acc[0] + acc[1]) + acc[2]) + acc[3])
    y = slices[0]
    for part in slices[1:]:
        y = y + part
    y = y + torch.stack([wts.w1h[-1], wts.w1w[-1]])[None, :, None, :]
    nrm = torch.stack([wts.nh, wts.nw])  # [2 dirs, scale/shift, R]
    if norm_kind == "group":
        vg = y.reshape(b, 2, l, gn_groups, r // gn_groups)
        mean = vg.mean(dim=(2, 4), keepdim=True)
        var = ((vg - mean) ** 2).mean(dim=(2, 4), keepdim=True)
        y = ((vg - mean) * torch.rsqrt(var + 1e-5)).reshape(b, 2, l, r)
    elif norm_kind != "affine":
        raise ValueError(f"unknown norm_kind {norm_kind!r}")
    yn = F.gelu(y * nrm[None, :, 0, None, :] + nrm[None, :, 1, None, :])
    yh, yw = yn[:, 0], yn[:, 1]
    wm = wts.wmix
    yx_h = yh @ wm[:r] + wm[r]  # h2w
    yx_w = yw @ wm[r + 1:2 * r + 1] + wm[2 * r + 1]  # w2h
    # pass 3: z, the gates of each block's tile, then the tile of out
    zh = yh + s[0] * yx_w
    zw = yw + s[1] * yx_h
    out = torch.empty_like(xf)
    rows, cw = plan.apply_rows, APPLY_CHANNELS
    for h0 in range(0, l, rows):
        for c0 in range(0, c, cw):
            cs = slice(c0, c0 + cw)
            gh = s[2] * torch.sigmoid(zh[:, h0:h0 + rows] @ wts.wout[:r, cs]
                                      + wts.bout[0, cs])
            gw = s[3] * torch.sigmoid(zw @ wts.wout[r:, cs] + wts.bout[1, cs])
            out[:, h0:h0 + rows, :, cs] = xf[:, h0:h0 + rows, :, cs] * (
                gh[:, :, None, :] + gw[:, None, :, :])
    return out.to(x.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("coord_attn")
    if lib.coord_attn_forward.argtypes is None:
        for fn in (lib.coord_attn_forward, lib.coord_attn_forward_bf16):
            fn.argtypes = [ctypes.c_void_p] * 7
            fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=256)
def _params(device: int, b: int, l: int, c: int, r: int, norm_kind: str,
            groups: int) -> ctypes.Array:
    """The C entry point's int parameters: the device, the shape and the
    launch plan."""
    plan = launch_plan(b, l, c, r, norm_kind, groups)
    return (ctypes.c_int * 15)(
        device, b, l, c, r, 0 if norm_kind == "group" else 1, groups,
        plan.pool_rows, plan.pool.block, plan.n_splits, plan.split_chunks,
        plan.n_stages, plan.apply_rows,
        plan.bottleneck.smem - BN_STATIC_SMEM, plan.apply.smem)


# Per (device, stream): the int32 counters of the bottleneck's last-block
# signals (one per sample and direction, then one per output tile for the
# k-slices) and a float32 scratch, reused by every call on that stream.
# The kernel leaves the counters at zero (each last block resets its own),
# so they are zeroed once, when made or grown, and a call needs neither a
# memset nor an allocation beyond its output. Calls on one stream are
# ordered; calls on two never share a buffer.
_workspaces: dict = {}


def _workspace(device: torch.device, stream: int, plan: LaunchPlan) -> tuple:
    """(counters, scratch) large enough for ``plan``."""
    key = (device.index, stream)
    counters, scratch = _workspaces.get(key, (None, None))
    if counters is None or counters.numel() < plan.counters:
        counters = torch.zeros(max(plan.counters, 1024), dtype=torch.int32,
                               device=device)
    if scratch is None or 4 * scratch.numel() < plan.scratch_bytes:
        scratch = torch.empty(plan.scratch_bytes // 4, dtype=torch.float32,
                              device=device)
    _workspaces[key] = (counters, scratch)
    return counters, scratch


_SHAPES = {"w1h": lambda c, r: (c + 1, r), "w1w": lambda c, r: (c + 1, r),
           "nh": lambda c, r: (2, r), "nw": lambda c, r: (2, r),
           "wmix": lambda c, r: (2 * (r + 1), r),
           "wout": lambda c, r: (2 * r, c), "bout": lambda c, r: (2, c)}
_FIELDS = tuple(f.name for f in fields(CoordAttnWeights))


# id(weights) -> (weakref to them, key, pointers, the fields pointed into)
_ptr_cache: dict = {}


def _weight_ptrs(wts: CoordAttnWeights, device: torch.device,
                 c: int) -> ctypes.Array:
    """The kernel's pointers to the packed weights, checked and, where
    needed, converted (float32, contiguous, on ``device``). Weights that
    need no conversion are checked once per weights object, device and C:
    the pointers are kept (beside references to the fields, so that no
    identity is reused) keyed on the fields' identities, so a field set
    anew is checked again and one changed in place is read as it is."""
    tensors = tuple(getattr(wts, f) for f in _FIELDS)
    key = (device, c, tuple(map(id, tensors)))
    hit = _ptr_cache.get(id(wts))
    if hit is not None and hit[0]() is wts and hit[1] == key:
        return hit[2]
    r = wts.w1h.shape[-1]
    ready = []
    for name, t in zip(_FIELDS, tensors):
        want = _SHAPES.get(name)
        if want is not None and tuple(t.shape) != want(c, r):
            raise ValueError(f"coord_attn: {name} must be "
                             f"{want(c, r)}, got {tuple(t.shape)}")
        if (t.device != device or t.dtype != torch.float32
                or not t.is_contiguous()):
            t = t.to(device=device, dtype=torch.float32).contiguous()
        ready.append(t)
    if ready[-1].numel() < 4:
        raise ValueError("coord_attn: scal needs 4 values")
    ptrs = (ctypes.c_void_p * len(ready))(*(t.data_ptr() for t in ready))
    if all(a is b for a, b in zip(ready, tensors)):
        if len(_ptr_cache) > 1024:
            _ptr_cache.clear()
        _ptr_cache[id(wts)] = (weakref.ref(wts), key, ptrs, tensors)
    else:  # converted copies: kept alive with the array until the launch
        ptrs._keep = ready
    return ptrs


def coord_attn(x: torch.Tensor, wts: CoordAttnWeights,
               norm_kind: str = "group", gn_groups: int = 4) -> torch.Tensor:
    """x: [B,L,L,C] contiguous NHWC (square maps), float32 or bfloat16.

    CPU tensors take :func:`coord_attn_plain`; CUDA tensors launch the
    kernel's three passes (``coord_attn.launches`` counts those calls)."""
    if x.device.type == "cpu":
        return coord_attn_plain(x, wts, norm_kind, gn_groups)
    if x.device.type != "cuda":
        raise ValueError(f"coord_attn: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(
            f"coord_attn: x must be [B,H,W,C], got {tuple(x.shape)}")
    b, h, w, c = x.shape
    r = wts.w1h.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"coord_attn: the kernel takes float32 or bfloat16,"
                        f" got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("coord_attn: x must be contiguous NHWC "
                         "(a channels_last NCHW tensor, permuted)")
    if h != w or h > MAX_SIDE:
        raise ValueError(f"coord_attn: the kernel takes square maps with "
                         f"side <= {MAX_SIDE}, got {h}x{w}")
    vec = 16 // x.element_size()  # channels per 16-byte access
    if x.data_ptr() % 16 or c % vec or b * h == 0:
        raise ValueError(f"coord_attn: needs a 16-byte aligned x with "
                         f"C % {vec} == 0 and no empty axis, got "
                         f"{tuple(x.shape)}")
    if norm_kind == "group":
        kind, groups = 0, gn_groups
        if groups < 1 or r % groups:
            raise ValueError(f"coord_attn: R={r} not divisible into "
                             f"{groups} groups")
    elif norm_kind == "affine":
        kind, groups = 1, 1
    else:
        raise ValueError(f"unknown norm_kind {norm_kind!r}")
    plan = launch_plan(b, h, c, r, norm_kind, groups, x.element_size())
    if max(plan.bottleneck.smem, plan.apply.smem) > MAX_DYNAMIC_SMEM:
        raise ValueError(f"coord_attn: L={h}, R={r} exceed a block's "
                         "shared memory")
    ptrs = _weight_ptrs(wts, x.device, c)
    out = torch.empty_like(x)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    counters, scratch = _workspace(x.device, stream, plan)
    params = _params(x.device.index, b, h, c, r, norm_kind, groups)
    fn = (lib.coord_attn_forward if x.dtype == torch.float32
          else lib.coord_attn_forward_bf16)
    err = fn(
        x.data_ptr(), ctypes.addressof(ptrs), out.data_ptr(),
        scratch.data_ptr(), counters.data_ptr(), ctypes.addressof(params),
        stream)
    _build.check(lib, err, "coord_attn")
    coord_attn.launches += 1
    return out


coord_attn.launches = 0


# ---------------------------------------------------------------- slab form
# x is this process's H-slab [B, h, L, C] (rows row0 .. row0 + h) of a map
# of side L whose H is split over the 'spatial' processes. The kernel's
# three passes already split where the collective goes (csrc/coord_attn.cu,
# "slab form"): coord_attn_slab_pool -> this slab's row means [B, h, C] and
# column sums [B, L, C]; the row means are gathered over the slabs and the
# column sums all-reduced; coord_attn_slab_mix -> the bottleneck's yn, yx
# [B, 2, L, R] on the whole map (replicated); coord_attn_slab_apply -> the
# slab times its gates. Each stage takes its kernel for a CUDA tensor and
# its plain twin for a CPU tensor, and counts its kernel's calls in its own
# ``launches`` (the pool call runs two kernels, the pass and the tile
# fold); :func:`coord_attn_slab` runs them with
# the collectives between, and :func:`coord_attn_slab_plain` runs the
# twins on any device (differentiable: the train path).


def coord_attn_slab_pool_plain(x: torch.Tensor):
    """(row means [B, h, C], column sums [B, L, C]) of a slab, float32."""
    xf = x.float()
    return xf.mean(dim=2), xf.sum(dim=1)


def coord_attn_slab_mix_plain(rmean: torch.Tensor, colsum: torch.Tensor,
                              wts: CoordAttnWeights, norm_kind: str = "group",
                              gn_groups: int = 4):
    """The bottleneck on the whole map's pooled terms (rmean [B, L, C] the
    row means, colsum [B, L, C] the column sums over all L rows): yn =
    GELU(norm(pooled @ W1 + b)) and the cross terms yx = yn @ Wx + bx (h2w
    for h, w2h for w), each [B, 2, L, R]."""
    l = rmean.shape[1]
    r = wts.w1h.shape[-1]
    mm = per_sample_matmul
    xh1 = mm(rmean, wts.w1h[:-1]) + wts.w1h[-1]
    xw1 = mm(colsum / l, wts.w1w[:-1]) + wts.w1w[-1]
    if norm_kind == "affine":
        xh1 = xh1 * wts.nh[0] + wts.nh[1]
        xw1 = xw1 * wts.nw[0] + wts.nw[1]
    elif norm_kind == "group":
        xh1 = _group_norm(xh1, gn_groups, wts.nh[0], wts.nh[1])
        xw1 = _group_norm(xw1, gn_groups, wts.nw[0], wts.nw[1])
    else:
        raise ValueError(f"unknown norm_kind {norm_kind!r}")
    yh, yw = F.gelu(xh1), F.gelu(xw1)
    yx_h = mm(yh, wts.wmix[:r]) + wts.wmix[r]
    yx_w = mm(yw, wts.wmix[r + 1:2 * r + 1]) + wts.wmix[2 * r + 1]
    return torch.stack([yh, yw], dim=1), torch.stack([yx_h, yx_w], dim=1)


def coord_attn_slab_apply_plain(x: torch.Tensor, yn: torch.Tensor,
                                yx: torch.Tensor, wts: CoordAttnWeights,
                                row0: int) -> torch.Tensor:
    """The slab x [B, h, L, C] (rows row0 .. row0 + h) times its gates:
    zh = yn_h + s0 * yx_w on its rows, zw = yn_w + s1 * yx_h,
    out = x * (s2 * sigmoid(zh @ Wh + bh) + s3 * sigmoid(zw @ Ww + bw))."""
    h = x.shape[1]
    r = wts.w1h.shape[-1]
    s = wts.scal.reshape(-1)
    rows = slice(row0, row0 + h)
    zh = yn[:, 0, rows] + s[0] * yx[:, 1, rows]
    zw = yn[:, 1] + s[1] * yx[:, 0]
    mm = per_sample_matmul
    a_h = torch.sigmoid(mm(zh, wts.wout[:r]) + wts.bout[0])
    a_w = torch.sigmoid(mm(zw, wts.wout[r:]) + wts.bout[1])
    attn = s[2] * a_h[:, :, None, :] + s[3] * a_w[:, None, :, :]
    return (x.float() * attn).to(x.dtype)


def coord_attn_slab_plain(x: torch.Tensor, wts: CoordAttnWeights,
                          norm_kind: str, gn_groups: int, group
                          ) -> torch.Tensor:
    """CoordAttn on this process's slab through the twins on any device,
    with ``group``'s differentiable gather and all_reduce between them
    (``parallel.spatial.SpatialGroup``)."""
    rmean, colsum = coord_attn_slab_pool_plain(x)
    yn, yx = coord_attn_slab_mix_plain(
        group.gather(rmean, dim=1), group.all_reduce(colsum), wts,
        norm_kind, gn_groups)
    return coord_attn_slab_apply_plain(x, yn, yx, wts,
                                       group.row0(x.shape[1]))


def coord_attn_slab(x: torch.Tensor, wts: CoordAttnWeights,
                    norm_kind: str, gn_groups: int, group) -> torch.Tensor:
    """CoordAttn on this process's slab x [B, h, L, C]: the pooling pass,
    the gather of the row means and the all_reduce of the column sums over
    ``group``'s slabs, the bottleneck on the whole map, the apply pass on
    the slab's rows. CUDA tensors launch the slab kernels (each stage
    counts its calls), CPU tensors take the twins."""
    rmean, colsum = coord_attn_slab_pool(x)
    yn, yx = coord_attn_slab_mix(group.gather(rmean, dim=1),
                                 group.all_reduce(colsum), wts, norm_kind,
                                 gn_groups)
    return coord_attn_slab_apply(x, yn, yx, wts, group.row0(x.shape[1]))


def _slab_lib() -> ctypes.CDLL:
    lib = _lib()
    if lib.coord_attn_slab_mix.argtypes is None:
        p = ctypes.c_void_p
        for fn in (lib.coord_attn_slab_pool, lib.coord_attn_slab_pool_bf16):
            fn.argtypes = [p] * 6
            fn.restype = ctypes.c_int
        lib.coord_attn_slab_mix.argtypes = [p] * 9
        lib.coord_attn_slab_mix.restype = ctypes.c_int
        for fn in (lib.coord_attn_slab_apply,
                   lib.coord_attn_slab_apply_bf16):
            fn.argtypes = [p] * 7
            fn.restype = ctypes.c_int
    return lib


def _check_slab_x(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"{what}: x must be [B,h,L,C], got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: the kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    vec = 16 // x.element_size()
    if (not x.is_contiguous() or x.data_ptr() % 16 or x.shape[3] % vec
            or x.numel() == 0):
        raise ValueError(f"{what}: needs a contiguous 16-byte aligned NHWC x"
                         f" with C % {vec} == 0, got {tuple(x.shape)}")
    if x.shape[2] > MAX_SIDE:
        raise ValueError(f"{what}: the kernel takes maps of side <= "
                         f"{MAX_SIDE}, got {x.shape[2]}")


def _groups(norm_kind: str, gn_groups: int, r: int) -> int:
    if norm_kind == "group":
        if gn_groups < 1 or r % gn_groups:
            raise ValueError(f"coord_attn: R={r} not divisible into "
                             f"{gn_groups} groups")
        return gn_groups
    if norm_kind == "affine":
        return 1
    raise ValueError(f"unknown norm_kind {norm_kind!r}")


def coord_attn_slab_pool(x: torch.Tensor):
    """(row means [B, h, C], column sums [B, L, C]) of the slab x
    [B, h, L, C], float32."""
    if x.device.type == "cpu":
        return coord_attn_slab_pool_plain(x)
    _check_slab_x(x, "coord_attn_slab_pool")
    b, h, l, c = x.shape
    plan = slab_plan(b, h, l, c, 1, "affine", 1, x.element_size())
    rmean = torch.empty((b, h, c), dtype=torch.float32, device=x.device)
    cp = torch.empty(plan.cp_bytes // 4, dtype=torch.float32, device=x.device)
    colsum = torch.empty((b, l, c), dtype=torch.float32, device=x.device)
    params = (ctypes.c_int * 7)(x.device.index, b, h, l, c, plan.pool_rows,
                                plan.pool.block)
    lib = _slab_lib()
    fn = (lib.coord_attn_slab_pool if x.dtype == torch.float32
          else lib.coord_attn_slab_pool_bf16)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(lib, fn(x.data_ptr(), rmean.data_ptr(), cp.data_ptr(),
                         colsum.data_ptr(), ctypes.addressof(params), stream),
                 "coord_attn_slab_pool")
    coord_attn_slab_pool.launches += 1
    return rmean, colsum


coord_attn_slab_pool.launches = 0


def coord_attn_slab_mix(rmean: torch.Tensor, colsum: torch.Tensor,
                        wts: CoordAttnWeights, norm_kind: str = "group",
                        gn_groups: int = 4):
    """(yn, yx) [B, 2, L, R] from the whole map's row means and column
    sums (each [B, L, C] float32), replicated on every slab's process."""
    if rmean.device.type == "cpu":
        return coord_attn_slab_mix_plain(rmean, colsum, wts, norm_kind,
                                         gn_groups)
    b, l, c = rmean.shape
    r = wts.w1h.shape[-1]
    groups = _groups(norm_kind, gn_groups, r)
    if tuple(colsum.shape) != (b, l, c) or l > MAX_SIDE:
        raise ValueError(f"coord_attn_slab_mix: rmean and colsum must be "
                         f"[B, L, C] with L <= {MAX_SIDE}, got "
                         f"{tuple(rmean.shape)}, {tuple(colsum.shape)}")
    dev = rmean.device
    rmean = rmean.to(torch.float32).contiguous()
    colsum = colsum.to(torch.float32).contiguous()
    plan = slab_plan(b, l, l, c, r, norm_kind, groups)
    if plan.bottleneck.smem > MAX_DYNAMIC_SMEM:
        raise ValueError(f"coord_attn: L={l}, R={r} exceed a block's "
                         "shared memory")
    ptrs = _weight_ptrs(wts, dev, c)
    stream = torch.cuda.current_stream(dev).cuda_stream
    counters, scratch = _workspace(dev, stream, plan)
    yn = torch.empty((b, 2, l, r), dtype=torch.float32, device=dev)
    yx = torch.empty_like(yn)
    params = (ctypes.c_int * 11)(
        dev.index, b, l, c, r, 0 if norm_kind == "group" else 1, groups,
        plan.n_splits, plan.split_chunks, plan.n_stages,
        plan.bottleneck.smem - BN_STATIC_SMEM)
    lib = _slab_lib()
    _build.check(lib, lib.coord_attn_slab_mix(
        rmean.data_ptr(), colsum.data_ptr(), ctypes.addressof(ptrs),
        scratch.data_ptr(), yn.data_ptr(), yx.data_ptr(),
        counters.data_ptr(), ctypes.addressof(params), stream),
        "coord_attn_slab_mix")
    coord_attn_slab_mix.launches += 1
    return yn, yx


coord_attn_slab_mix.launches = 0


def coord_attn_slab_apply(x: torch.Tensor, yn: torch.Tensor,
                          yx: torch.Tensor, wts: CoordAttnWeights,
                          row0: int) -> torch.Tensor:
    """The slab x [B, h, L, C] (rows row0 .. row0 + h) times its gates
    from the whole map's yn, yx [B, 2, L, R]."""
    if x.device.type == "cpu":
        return coord_attn_slab_apply_plain(x, yn, yx, wts, row0)
    _check_slab_x(x, "coord_attn_slab_apply")
    b, h, l, c = x.shape
    r = wts.w1h.shape[-1]
    if tuple(yn.shape) != (b, 2, l, r) or tuple(yx.shape) != (b, 2, l, r) \
            or not 0 <= row0 <= l - h:
        raise ValueError(f"coord_attn_slab_apply: yn, yx must be "
                         f"{(b, 2, l, r)} and rows {row0}..{row0 + h} in "
                         f"0..{l}, got {tuple(yn.shape)}, {tuple(yx.shape)}")
    plan = slab_plan(b, h, l, c, r, "affine", 1, x.element_size())
    if plan.apply.smem > MAX_DYNAMIC_SMEM:
        raise ValueError(f"coord_attn: L={l}, R={r} exceed a block's "
                         "shared memory")
    ptrs = _weight_ptrs(wts, x.device, c)
    yn, yx = yn.contiguous(), yx.contiguous()
    out = torch.empty_like(x)
    params = (ctypes.c_int * 9)(x.device.index, b, h, l, c, r, row0,
                                plan.apply_rows, plan.apply.smem)
    lib = _slab_lib()
    fn = (lib.coord_attn_slab_apply if x.dtype == torch.float32
          else lib.coord_attn_slab_apply_bf16)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(lib, fn(x.data_ptr(), yn.data_ptr(), yx.data_ptr(),
                         ctypes.addressof(ptrs),
                         out.data_ptr(), ctypes.addressof(params), stream),
                 "coord_attn_slab_apply")
    coord_attn_slab_apply.launches += 1
    return out


coord_attn_slab_apply.launches = 0
