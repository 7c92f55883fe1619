"""Squeeze-excitation: the hand-written CUDA kernel and its plain twin.

Counterpart of ``diffusionmodel_tpu/kernels/se_block.py``. The kernel
(``csrc/se_block.cu``) replaces the Pallas kernel reached from
``se_block_fused``; the source notes its design and what bounds it.

:func:`se_block` takes the kernel for a CUDA tensor and the plain PyTorch
twin :func:`se_block_plain` for a CPU tensor, and raises for anything the
kernel does not take. It never falls back from CUDA to the twin.

The kernel is one cooperative launch that keeps each sample's x in shared
memory between pooling and scaling; :func:`launch_plan` sizes it in plain
Python, and :func:`se_block_staged` follows its tiles, parts and order of
summation in plain torch, for the tests and as documentation.

x is float32 or bfloat16. In bfloat16 both compute what the Pallas kernel
computes on bf16 x (pooling and MLP in float32, the gate rounded to bf16,
one rounding of the product), not what the SE module's own XLA path
computes (``nn.blocks.se_module_plain``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from diffusionmodel_tpu_torch.kernels import _build, per_sample_matmul

# The kernel's constants (csrc/se_block.cu): threads per block, the bytes of
# a tile and the ring's slots of shared memory, the most channels a tile
# row holds, the widest R, and the floats of its reduction scratch.
THREADS = 512
TILE_BYTES = 32 * 1024
SLOTS = 6
MAX_SLICE_CHANNELS = 64
MAX_R = 1024
SCRATCH_FLOATS = 1024
# A sample is cut into at most this many parts, one per block: the SMs of an
# H100 SXM. It fixes the partition for every card; a card with fewer
# resident blocks than a shape's parts is refused.
NOMINAL_BLOCKS = 132
SMS = 132


class LaunchPlan(NamedTuple):
    row_vectors: int  # 16-byte vectors of a tile row (a channel slice)
    slice_channels: int
    tile_pixels: int
    slices: int  # channel slices per sample
    pixel_tiles: int  # tiles per slice (the last may hold fewer pixels)
    tiles: int  # tiles per sample, slice-major
    tiles_per_part: int
    parts: int  # parts per sample (the last may hold fewer tiles)
    streamed: int  # tiles of a full part pooled in passing and re-read
    samples_per_wave: int  # samples whose tiles the ring holds at once
    smem: int  # dynamic shared memory per block, bytes
    grid: int
    bytes_read: int  # x once, the weights once
    bytes_reread: int  # x read again (streamed tiles)
    bytes_written: int
    scratch_bytes: int  # the parts' published R-vectors, 8 bytes a value


def _elem_bytes(dtype: torch.dtype) -> int:
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"se_block: the kernel takes float32 or bfloat16, "
                        f"got {dtype}")
    return dtype.itemsize


def smem_bytes(r: int) -> int:
    """Dynamic shared memory of one block for this R (the kernel's
    ``smem_bytes``): the ring, the slice reductions and two R-vectors."""
    rp = (r + 3) // 4 * 4
    return SLOTS * TILE_BYTES + 4 * (
        (THREADS // 32) * MAX_SLICE_CHANNELS + 2 * MAX_SLICE_CHANNELS
        + SCRATCH_FLOATS + 2 * rp)


@functools.lru_cache(maxsize=256)
def launch_plan(b: int, h: int, w: int, c: int, r: int, dtype=torch.float32,
                sms: int = SMS, blocks_per_sm: int = 1) -> LaunchPlan:
    """The kernel's partition and launch for x [b, h, w, c] of ``dtype``
    and R = r, on a card of ``sms`` SMs holding ``blocks_per_sm`` blocks
    each. Plain Python, so the CPU tests check it; the wrapper hands its
    numbers to the C entry point.

    A tile row is the widest run of 1, 2, 4 or 8 16-byte vectors (at most
    128 bytes) that divides a pixel's channels: a channel slice. A tile is
    ``tile_pixels`` consecutive pixels of one slice (32 KB); a sample's
    tiles run slice-major. A part is ``tiles_per_part`` consecutive tiles:
    as many as the ring holds (``SLOTS``: each part carries a fixed cost,
    its fold, publication, wait and gate), unless a sample would then need
    more than ``NOMINAL_BLOCKS`` parts; then as few as keep it to that. A
    part of more than ``SLOTS`` tiles keeps its last ``SLOTS`` tiles on chip
    and re-reads the others. All of this depends on (h, w, c, dtype) and r,
    never on b or the grid."""
    eb = _elem_bytes(dtype)
    vec = 16 // eb
    hw = h * w
    if c % vec or hw == 0 or b < 1:
        raise ValueError(f"se_block: needs C % {vec} == 0 and no empty axis,"
                         f" got {(b, h, w, c)}")
    if not 1 <= r <= MAX_R:
        raise ValueError(f"se_block: R={r} exceeds the kernel's shared "
                         f"memory (R <= {MAX_R})")
    cv = c // vec
    sv = next(n for n in (8, 4, 2, 1) if cv % n == 0)
    tile_pixels = TILE_BYTES // (16 * sv)
    slices = cv // sv
    pixel_tiles = -(-hw // tile_pixels)
    tiles = slices * pixel_tiles
    tpb = max(SLOTS, -(-tiles // NOMINAL_BLOCKS))
    parts = -(-tiles // tpb)
    grid = min(b * parts, sms * blocks_per_sm)
    if parts > sms * blocks_per_sm:
        raise ValueError(f"se_block: {parts} parts per sample exceed the "
                         f"{sms * blocks_per_sm} resident blocks")
    row = 16 * sv

    def tile_bytes(t):
        p0 = (t % pixel_tiles) * tile_pixels
        return min(tile_pixels, hw - p0) * row

    reread = 0
    for k in range(parts):
        t0 = k * tpb
        nt = min(tpb, tiles - t0)
        reread += sum(tile_bytes(t) for t in range(t0, t0 + nt - SLOTS))
    x_bytes = b * hw * c * eb
    return LaunchPlan(
        row_vectors=sv, slice_channels=sv * vec, tile_pixels=tile_pixels,
        slices=slices, pixel_tiles=pixel_tiles, tiles=tiles,
        tiles_per_part=tpb, parts=parts, streamed=max(0, tpb - SLOTS),
        samples_per_wave=min(b, max(1, grid * SLOTS // tiles)),
        smem=smem_bytes(r), grid=grid,
        bytes_read=x_bytes + 2 * c * r * 4, bytes_reread=b * reread,
        bytes_written=x_bytes, scratch_bytes=8 * b * parts * r)


def se_block_plain(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor
                   ) -> torch.Tensor:
    """x: [B,H,W,C]; w1: [C,R]; w2: [R,C]. x * sigmoid(GELU(mean @ w1) @ w2).
    The twin of the kernel's function (``se_block_fused``, with exact-erf
    GELU as ``se_block_xla``): the mean and the MLP in float32, the gate
    rounded to x's dtype, then x times the gate in float32 (exact for bf16
    operands) rounded once to x's dtype."""
    xf = x.float()
    pooled = xf.mean(dim=(1, 2))
    y = torch.sigmoid(per_sample_matmul(
        F.gelu(per_sample_matmul(pooled, w1.float())), w2.float()))
    gate = y.to(x.dtype).float()
    return (xf * gate[:, None, None, :]).to(x.dtype)


def se_block_staged(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor
                    ) -> torch.Tensor:
    """The kernel's stages in plain torch, sample by sample: each part's
    tiles summed per channel, the sums of each channel slice within a part
    folded into the part's R-vector (``sums @ w1[slice]``), the R-vectors
    added in part order and divided by H*W, GELU, then per slice the gate
    ``sigmoid(hidden @ w2[:, slice])`` rounded to x's dtype and x times the
    gate rounded once. For tests and docs; the main path never calls it.
    x: [B,H,W,C]; w1: [C,R]; w2: [R,C]."""
    b, h, w, c = x.shape
    r = w1.shape[1]
    plan = launch_plan(b, h, w, c, r, x.dtype)
    cs, tp, npr = plan.slice_channels, plan.tile_pixels, plan.pixel_tiles
    w1f, w2f = w1.float(), w2.float()
    out = torch.empty_like(x)
    for i in range(b):
        xs = x[i].reshape(h * w, c).float()
        rvs = []
        for k in range(plan.parts):
            rv = torch.zeros(r)
            seg, seg_s = None, None
            t0 = k * plan.tiles_per_part
            for t in range(t0, min(plan.tiles, t0 + plan.tiles_per_part)):
                s, p0 = t // npr, (t % npr) * tp
                part = xs[p0:p0 + tp, s * cs:(s + 1) * cs].sum(dim=0)
                if seg_s != s:
                    if seg is not None:
                        rv = rv + seg @ w1f[seg_s * cs:(seg_s + 1) * cs]
                    seg, seg_s = part, s
                else:
                    seg = seg + part
            rvs.append(rv + seg @ w1f[seg_s * cs:(seg_s + 1) * cs])
        total = rvs[0]
        for rv in rvs[1:]:
            total = total + rv
        hid = F.gelu(total / (h * w))
        gate = torch.cat([torch.sigmoid(hid @ w2f[:, s * cs:(s + 1) * cs])
                          for s in range(plan.slices)]).to(x.dtype).float()
        out[i] = (x[i].float() * gate).to(x.dtype)
    return out


def _lib() -> ctypes.CDLL:
    lib = _build.load("se_block")
    if lib.se_block_forward.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.se_block_forward, lib.se_block_forward_bf16):
            fn.argtypes = [p] * 6 + [ctypes.c_uint, p]
            fn.restype = ctypes.c_int
        lib.se_max_blocks.argtypes = [i, i, i, ctypes.POINTER(i)]
        lib.se_max_blocks.restype = i
        lib.se_smem_bytes.argtypes = [i]
        lib.se_smem_bytes.restype = i
    return lib


@functools.lru_cache(maxsize=64)
def _resident(device: int, bf16: bool, r: int) -> tuple:
    """(SMs, blocks per SM) of the card for the kernel with this R, from
    the occupancy API."""
    lib = _lib()
    smem = smem_bytes(r)
    if lib.se_smem_bytes(r) != smem:
        raise RuntimeError("se_block: the kernel's shared memory layout "
                           "differs from launch_plan's")
    blocks = ctypes.c_int(0)
    _build.check(lib, lib.se_max_blocks(device, int(bf16), smem,
                                        ctypes.byref(blocks)), "se_block")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms, blocks.value


@functools.lru_cache(maxsize=256)
def _params(device: int, b: int, h: int, w: int, c: int, r: int, dtype,
            sms: int, per_sm: int) -> ctypes.Array:
    plan = launch_plan(b, h, w, c, r, dtype, sms, per_sm)
    return (ctypes.c_int * 13)(
        device, b, h * w, c, r, plan.row_vectors, plan.tile_pixels,
        plan.pixel_tiles, plan.tiles, plan.tiles_per_part, plan.parts,
        plan.grid, plan.smem)


# Per (device, stream): the words the parts publish their R-vectors in (an
# fp32 value and the epoch of the call that wrote it) and the epoch of the
# last call. Zeroed once, when made or grown (epoch 0 is never a call's), so
# a call needs neither a memset nor an allocation beyond its output. Calls
# on one stream are ordered; calls on two never share a buffer.
_workspaces: dict = {}


def _workspace(device: torch.device, stream: int, plan: LaunchPlan) -> tuple:
    """(published words, epoch) large enough for ``plan``; a fresh epoch."""
    key = (device.index, stream)
    words, epoch = _workspaces.get(key, (None, 0))
    if words is None or 8 * words.numel() < plan.scratch_bytes:
        words = torch.zeros(max(plan.scratch_bytes // 8, 4096),
                            dtype=torch.int64, device=device)
    epoch = epoch % 0xFFFFFFFF + 1  # never 0
    _workspaces[key] = (words, epoch)
    return words, epoch


def se_block(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor
             ) -> torch.Tensor:
    """x: [B,H,W,C] contiguous NHWC, float32 or bfloat16; w1: [C,R];
    w2: [R,C] (used in float32). The kernel reads the weights as
    ``w1.t()`` and ``w2.t()`` (nn.Linear's layout): for the transposed
    views of ``SEBlock``'s ``fc`` weights that copies nothing.

    CPU tensors take :func:`se_block_plain`; CUDA tensors launch the
    kernel (``se_block.launches`` counts those calls)."""
    if x.device.type == "cpu":
        return se_block_plain(x, w1, w2)
    if x.device.type != "cuda":
        raise ValueError(f"se_block: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"se_block: x must be [B,H,W,C], got {tuple(x.shape)}")
    b, h, w, c = x.shape
    r = w1.shape[1] if w1.dim() == 2 else -1
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(
            f"se_block: the kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("se_block: x must be contiguous NHWC "
                         "(a channels_last NCHW tensor, permuted)")
    vec = 16 // x.element_size()  # channels per 16-byte access
    if x.data_ptr() % 16 or c % vec or b * h * w == 0:
        raise ValueError(f"se_block: needs a 16-byte aligned x with C % {vec}"
                         f" == 0 and no empty axis, got {tuple(x.shape)}")
    if tuple(w1.shape) != (c, r) or tuple(w2.shape) != (r, c):
        raise ValueError(f"se_block: weights must be [C,R] and [R,C] for "
                         f"C={c}, got {tuple(w1.shape)} and {tuple(w2.shape)}")
    if r > MAX_R:
        raise ValueError(f"se_block: R={r} exceeds the kernel's shared "
                         f"memory (R <= {MAX_R})")
    dev = x.device.index
    w1t = w1.t().to(device=x.device, dtype=torch.float32).contiguous()
    w2t = w2.t().to(device=x.device, dtype=torch.float32).contiguous()
    sms, per_sm = _resident(dev, x.dtype == torch.bfloat16, r)
    plan = launch_plan(b, h, w, c, r, x.dtype, sms, per_sm)
    out = torch.empty_like(x)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    words, epoch = _workspace(x.device, stream, plan)
    params = _params(dev, b, h, w, c, r, x.dtype, sms, per_sm)
    fn = (lib.se_block_forward if x.dtype == torch.float32
          else lib.se_block_forward_bf16)
    err = fn(x.data_ptr(), w1t.data_ptr(), w2t.data_ptr(), out.data_ptr(),
             words.data_ptr(), ctypes.addressof(params), epoch, stream)
    _build.check(lib, err, "se_block")
    se_block.launches += 1
    return out


se_block.launches = 0
