"""Exact fusion of bilinear-x2 (align_corners) upsample + 3x3 conv
(counterpart of ``diffusionmodel_tpu/ops/fused_upconv.py``,
``model.fused_upsample``).

The align-corners upsample is two separable matmuls (x_up = Mh @ x @ Mw^T)
and a 3x3 conv is the sum of three 1x3 convs at H-offsets d in {-1,0,+1};
the H-matmul commutes with each 1x3 conv, so

    conv3x3(Mh @ x @ Mw^T) = sum_d  Mh^(d) @ conv1x3_{K[d]}(x @ Mw^T)

with Mh^(d)[p, i] = Mh[p+d-1, i] (zero rows outside: the conv's zero
padding on the upsampled grid). Three stages, all in the operand dtype:
the W-interpolation matmul, one conv with 3*Cout outputs at half the
rows, and the three shifted H-matmuls contracted in one einsum. The
4x-resolution Cin intermediate is never formed. No stage widens its
output: as in the JAX package, each stage rounds to the operand dtype,
which is what makes bf16 round at other places than the unfused pair.

These are plain matmuls and a convolution, which the JAX package leaves
to XLA outside any Pallas kernel; the port leaves them to PyTorch (the
convolution one sample at a time in bf16 inference, as the net's own:
``kernels.per_sample_conv``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from diffusionmodel_tpu_torch.kernels import per_sample_conv
from diffusionmodel_tpu_torch.ops.resize import _align_corners_matrix


@lru_cache(maxsize=32)
def _shifted_h_matrices(h: int) -> np.ndarray:
    """[3, 2h, h]: Mh shifted by d-1 rows, zero rows at the borders."""
    mh = _align_corners_matrix(h, 2 * h)
    pad = np.zeros((1, h), np.float32)
    mhp = np.concatenate([pad, mh, pad], axis=0)  # [2h+2, h]
    return np.stack([mhp[d:d + 2 * h] for d in range(3)])


def up2_conv3x3_align_corners(x: torch.Tensor, kernel: torch.Tensor,
                              bias: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """conv3x3(bilinear_up2_align_corners(x)) without forming the
    upsampled tensor, in x's dtype. x: [N,H,W,Cin]; kernel: [3,3,Cin,Cout]
    (flax HWIO, the JAX function's layout); bias: [Cout] or None. Returns
    [N,2H,2W,Cout]."""
    return _up2_conv3x3(x, kernel.permute(3, 2, 0, 1), bias)


def up2_conv3x3_align_corners_nchw(x: torch.Tensor, weight: torch.Tensor,
                                   bias: torch.Tensor | None = None,
                                   rows=None) -> torch.Tensor:
    """The same on an NCHW view (channels_last memory inside the net) with
    a PyTorch conv weight [Cout, Cin, 3, 3]; returns an NCHW view of
    channels_last memory.

    ``rows=(row0, h, H)``: x is an H-slab (rows row0 .. row0 + h of a map
    of H rows) with one halo row on each side, and the result is the
    slab's rows 2 * row0 .. 2 * (row0 + h) of the whole map's result: the
    three shifted H-matrices are the whole map's, cut to those output rows
    and to the haloed slab's columns (the taps of those rows reach at most
    one row past the slab)."""
    x = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
    return _up2_conv3x3(x, weight, bias, rows).permute(0, 3, 1, 2)


@lru_cache(maxsize=64)
def _slab_h_matrices(row0: int, h: int, full: int) -> np.ndarray:
    """[3, 2h, h+2]: the rows 2*row0 .. 2*(row0+h) of
    ``_shifted_h_matrices(full)`` on the columns row0-1 .. row0+h (zero
    outside the map)."""
    eh = np.pad(_shifted_h_matrices(full), ((0, 0), (0, 0), (1, 1)))
    return np.ascontiguousarray(
        eh[:, 2 * row0:2 * (row0 + h), row0:row0 + h + 2])


def _up2_conv3x3(x: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor | None, rows=None) -> torch.Tensor:
    """x: [N,H,W,Cin] (NHWC); weight: [Cout, Cin, 3, 3]. Returns NHWC."""
    n, h, w, _ = x.shape
    cout = weight.shape[0]
    dt, dev = x.dtype, x.device
    mw = torch.from_numpy(_align_corners_matrix(w, 2 * w)).to(dev, dt)
    if rows is None:
        eh = torch.from_numpy(_shifted_h_matrices(h)).to(dev, dt)
    else:
        eh = torch.from_numpy(_slab_h_matrices(*rows)).to(dev, dt)
    # 1) W-upsample: the half-size intermediate [N, H, 2W, Cin]
    xw = torch.einsum("ow,nhwc->nhoc", mw, x)
    # 2) the three 1x3 row-convs as one conv with 3*Cout outputs:
    #    output channel d*Cout + o is kernel row d of output o
    kstack = torch.cat([weight[:, :, d:d + 1, :] for d in range(3)]).to(dt)
    c = per_sample_conv(lambda a: F.conv2d(a, kstack, padding=(0, 1)),
                        xw.permute(0, 3, 1, 2))
    c = c.permute(0, 2, 3, 1).reshape(n, h, 2 * w, 3, cout)
    # 3) the three shifted H-upsample matmuls, contracted in one einsum
    y = torch.einsum("dph,nhwdc->npwc", eh, c)
    if bias is not None:
        y = y + bias.to(dt)
    return y.contiguous()
