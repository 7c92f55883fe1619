"""GroupNorm + activation in bf16, NHWC: the hand-written CUDA kernel and its
plain twin.

No TPU kernel is replaced: the JAX package leaves GroupNorm to XLA, which
fuses it with the cast and the activation around it. The kernel
(``csrc/group_norm.cu``) was added for the card, where PyTorch runs the same
chain on a bf16 channels_last map as seven kernels and ~58 bytes of device
memory traffic an element; the source notes its design and what bounds it.

:func:`group_norm_act` takes the kernel for a CUDA tensor and the plain
PyTorch twin :func:`group_norm_act_plain` for a CPU tensor, and raises for
anything the kernel does not take. It never falls back from CUDA to the
twin. ``nn.blocks.GroupNorm`` calls it where the kernel applies (bf16
inference on a whole map with ``use_pallas``, of a shape :func:`takes`
accepts) and runs the twin's arithmetic everywhere else.

The twin is the bf16 program's own arithmetic: ``F.group_norm`` on the
float32 values, rounded once to bf16, then :func:`gelu` or ReLU in bf16. The
kernel computes the same, with the statistics summed in another order, so an
element of its normalised output lies one bf16 ulp from the twin's where a
rounding boundary falls between the two sums, and the activation then
follows that value through the same bf16 steps.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from diffusionmodel_tpu_torch import tracing
from diffusionmodel_tpu_torch.kernels import _build

# The kernel's limits (csrc/group_norm.cu): threads per block, 16-byte
# vectors per pixel (C / 8), groups, and the parts a sample may be cut into
# (one resident block each; the H100 SXM's 132 SMs).
MAX_THREADS = 512
MAX_CHANNELS = 8 * MAX_THREADS
MAX_GROUPS = 1024
MAX_PARTS = 132
# A part holds at least this many bytes of x, so that its fixed cost (the
# merges, the publication and the wait) is spread over enough loads.
PART_BYTES = 64 * 1024
ACTS = {None: 0, "gelu": 1, "relu": 2}
ERFC_TABLE = 4096  # GELU's bf16 erfc values in shared memory


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, torch ``nn.GELU()``'s default. Below float32 it
    follows ``jax.nn.gelu(approximate=False)`` op for op, rounding where
    the JAX program rounds: ``0.5*x * erfc(-x * sqrt(1/2))`` with
    sqrt(1/2) in x's dtype and each product and the erfc rounded to it."""
    if x.dtype == torch.float32:
        return F.gelu(x)
    return (x * 0.5) * torch.erfc(x * torch.tensor(-0.5 ** 0.5, dtype=x.dtype))


def activation(y: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    """``act`` (None, "gelu" or "relu") of y, in y's dtype."""
    if act is None:
        return y
    if act == "gelu":
        return gelu(y)
    if act == "relu":
        return torch.relu(y)
    raise ValueError(f"unknown activation {act!r}")


def group_norm_f32(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   groups: int, eps: float) -> torch.Tensor:
    """``F.group_norm`` of x [B,C,H,W] in float32, channels_last out. On a
    CPU tensor each sample is normalised on its own: the CPU kernel splits
    its work across samples by thread count (3 intra-op threads do), which
    would let batch neighbours move a sample's result. CUDA tensors take
    one call for the batch."""
    x = x.float()
    cl = torch.channels_last
    if x.device.type == "cpu" and x.shape[0] > 1:
        return torch.cat([F.group_norm(s, groups, weight, bias, eps)
                          .contiguous(memory_format=cl) for s in x.split(1)])
    return F.group_norm(x, groups, weight, bias, eps).contiguous(
        memory_format=cl)


def group_norm_act_plain(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, groups: int, eps: float = 1e-5,
                         act: Optional[str] = None) -> torch.Tensor:
    """x: [B,H,W,C] (NHWC). GroupNorm of the float32 values with the float32
    affine, rounded once to x's dtype, then ``act`` in x's dtype."""
    y = group_norm_f32(x.permute(0, 3, 1, 2), weight, bias, groups, eps)
    return activation(y.to(x.dtype), act).permute(0, 2, 3, 1)


class LaunchPlan(NamedTuple):
    vectors: int  # 16-byte vectors of a pixel (C / 8)
    lanes: int  # pixels a block reads at once, one vector column a thread
    threads: int  # lanes * vectors, rounded up to whole warps
    part_pixels: int
    parts: int  # parts per sample (the last may hold fewer pixels)
    grid: int
    smem: int  # dynamic shared memory per block, bytes
    words: int  # published 8-byte words of a call
    bytes_read: int  # x twice, the affine once
    bytes_written: int


def takes(b: int, h: int, w: int, c: int, groups: int) -> bool:
    """Whether the kernel takes x [b, h, w, c] in ``groups`` groups: the one
    statement of its shape limits, which :func:`launch_plan` and the
    wrapper enforce and ``nn.blocks.GroupNorm`` asks before it dispatches.
    C is whole 16-byte vectors and fits a block; the groups divide C; no
    axis is empty; and a group holds at most 2**24 values, the counts
    float32 holds exactly."""
    return (c % 8 == 0 and 0 < c <= MAX_CHANNELS and 0 < groups <= MAX_GROUPS
            and c % groups == 0 and b >= 1 and h * w >= 1
            and h * w * (c // groups) <= 1 << 24)


def smem_bytes(lanes: int, c: int, groups: int) -> int:
    """The kernel's ``smem_bytes``: the lanes' per-channel (mean, M2) and
    the sample's per-group mean and rstd, float32, and GELU's table of
    4096 bf16 erfc values."""
    return 4 * (2 * lanes * c + 2 * groups) + 2 * ERFC_TABLE


@functools.lru_cache(maxsize=256)
def launch_plan(b: int, h: int, w: int, c: int, groups: int,
                sms: int = MAX_PARTS, blocks_per_sm: int = 1) -> LaunchPlan:
    """The kernel's partition and launch for bf16 x [b, h, w, c] in
    ``groups`` groups, on a card of ``sms`` SMs holding ``blocks_per_sm``
    blocks each. Plain Python, so the CPU tests check it; the wrapper hands
    its numbers to the C entry point.

    A thread reads one 16-byte vector column of a pixel; a block reads
    ``lanes`` pixels at once (as many as 512 threads cover). A part is
    ``part_pixels`` consecutive pixels of one sample: at least
    ``PART_BYTES`` of x, and few enough that a sample has at most
    ``MAX_PARTS`` parts, and no more parts than the card holds blocks at
    once. All of this depends on (h, w, c) and the card alone, never on b
    or a sample's position, so a sample's sums run in the same order in any
    batch."""
    if not takes(b, h, w, c, groups):
        raise ValueError(
            f"group_norm_act: needs C % 8 == 0, C <= {MAX_CHANNELS}, C % "
            f"groups == 0, groups <= {MAX_GROUPS}, no empty axis and at "
            f"most 2**24 values a group, got {(b, h, w, c)} in {groups} "
            "groups")
    resident = sms * blocks_per_sm
    if resident < 1:
        raise RuntimeError("group_norm_act: the card holds no block of the "
                           "kernel")
    hw = h * w
    cv = c // 8
    lanes = MAX_THREADS // cv
    part = max(-(-hw // min(MAX_PARTS, resident)),
               -(-PART_BYTES // (2 * c)))
    parts = -(-hw // part)
    grid = min(b * parts, resident)
    x_bytes = b * hw * c * 2
    return LaunchPlan(
        vectors=cv, lanes=lanes, threads=-(-lanes * cv // 32) * 32,
        part_pixels=part, parts=parts, grid=grid,
        smem=smem_bytes(lanes, c, groups), words=2 * b * parts * groups,
        bytes_read=2 * x_bytes + 2 * c * 4, bytes_written=x_bytes)


def _lib() -> ctypes.CDLL:
    lib = _build.load("group_norm")
    if lib.group_norm_act_bf16.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.group_norm_act_bf16.argtypes = [p] * 6 + [
            ctypes.c_float, ctypes.c_uint, p]
        lib.group_norm_act_bf16.restype = i
        lib.gn_max_blocks.argtypes = [i, i, i, i, ctypes.POINTER(i)]
        lib.gn_max_blocks.restype = i
        lib.gn_smem_bytes.argtypes = [i, i, i]
        lib.gn_smem_bytes.restype = i
    return lib


@functools.lru_cache(maxsize=256)
def _resident(device: int, act: int, threads: int, smem: int) -> tuple:
    """(SMs, blocks per SM) of the card for a block of ``threads`` threads
    and ``smem`` bytes, from the occupancy API."""
    lib = _lib()
    blocks = ctypes.c_int(0)
    _build.check(lib, lib.gn_max_blocks(device, act, threads, smem,
                                        ctypes.byref(blocks)),
                 "group_norm_act")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms, blocks.value


@functools.lru_cache(maxsize=256)
def _params(device: int, b: int, h: int, w: int, c: int, groups: int,
            act: int, sms: int, per_sm: int) -> ctypes.Array:
    plan = launch_plan(b, h, w, c, groups, sms, per_sm)
    lanes = plan.lanes
    if _lib().gn_smem_bytes(lanes, c, groups) != plan.smem:
        raise RuntimeError("group_norm_act: the kernel's shared memory "
                           "layout differs from launch_plan's")
    return (ctypes.c_int * 12)(
        device, b, h * w, c, groups, lanes, plan.threads, plan.part_pixels,
        plan.parts, plan.grid, plan.smem, act)


# Per (device, stream): the words the parts publish their statistics in (an
# fp32 value and the epoch of the call that wrote it) and the epoch of the
# last call. Zeroed once, when made or grown (epoch 0 is never a call's), so
# a call needs neither a memset nor an allocation beyond its output.
_workspaces: dict = {}


def _workspace(device: torch.device, stream: int, words: int) -> tuple:
    """(published words, epoch) holding at least ``words``; a fresh epoch."""
    key = (device.index, stream)
    buf, epoch = _workspaces.get(key, (None, 0))
    if buf is None or buf.numel() < words:
        buf = torch.zeros(max(words, 4096), dtype=torch.int64, device=device)
    epoch = epoch % 0xFFFFFFFF + 1  # never 0
    _workspaces[key] = (buf, epoch)
    return buf, epoch


def on_card(x: torch.Tensor) -> bool:
    """Whether x lives on the card (the check the CPU tests mock)."""
    return x.device.type == "cuda"


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           groups: int, act: Optional[str]) -> None:
    """Raise for an x, affine or activation the kernel does not take."""
    if x.dim() != 4:
        raise ValueError(f"group_norm_act: x must be [B,H,W,C], got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"group_norm_act: the kernel takes bfloat16 x, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("group_norm_act: x must be contiguous NHWC "
                         "(a channels_last NCHW tensor, permuted)")
    c = x.shape[3]
    if x.data_ptr() % 16 or not takes(*x.shape, groups):
        raise ValueError(
            f"group_norm_act: needs a 16-byte aligned x with C % 8 == 0, C <= "
            f"{MAX_CHANNELS}, C % groups == 0, groups <= {MAX_GROUPS}, no "
            f"empty axis and at most 2**24 values a group, got "
            f"{tuple(x.shape)} in {groups} groups")
    if tuple(weight.shape) != (c,) or tuple(bias.shape) != (c,):
        raise ValueError(f"group_norm_act: weight and bias must be [C] for "
                         f"C={c}, got {tuple(weight.shape)} and "
                         f"{tuple(bias.shape)}")
    if act not in ACTS:
        raise ValueError(f"group_norm_act: unknown activation {act!r}")


def group_norm_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   groups: int, eps: float = 1e-5,
                   act: Optional[str] = None) -> torch.Tensor:
    """x: [B,H,W,C] contiguous NHWC (a channels_last NCHW tensor, permuted);
    weight, bias: [C] (used in float32); ``act``: None, "gelu" or "relu".
    GroupNorm in ``groups`` groups, then ``act``, in x's dtype.

    CPU tensors take :func:`group_norm_act_plain`; CUDA tensors must be
    bf16 and launch the kernel (``group_norm_act.launches`` counts those
    calls; with ``tracing`` on each adds 1 to ``group_norm.fused_calls``)."""
    if x.device.type == "cpu":
        return group_norm_act_plain(x, weight, bias, groups, eps, act)
    if not on_card(x):
        raise ValueError(f"group_norm_act: unsupported device {x.device}")
    _check(x, weight, bias, groups, act)
    return _launch(x, weight, bias, groups, eps, act)


group_norm_act.launches = 0


def _launch(x, weight, bias, groups, eps, act) -> torch.Tensor:
    b, h, w, c = x.shape
    dev, code = x.device.index, ACTS[act]
    plan = launch_plan(b, h, w, c, groups)
    sms, per_sm = _resident(dev, code, plan.threads, plan.smem)
    params = _params(dev, b, h, w, c, groups, code, sms, per_sm)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    words, epoch = _workspace(x.device, stream, plan.words)
    wt = weight.to(device=x.device, dtype=torch.float32).contiguous()
    bt = bias.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty_like(x)
    lib = _lib()
    err = lib.group_norm_act_bf16(
        x.data_ptr(), wt.data_ptr(), bt.data_ptr(), out.data_ptr(),
        words.data_ptr(), ctypes.addressof(params), ctypes.c_float(eps),
        epoch, stream)
    _build.check(lib, err, "group_norm_act")
    group_norm_act.launches += 1
    tracing.count("group_norm.fused_calls")
    return out
