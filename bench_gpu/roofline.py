"""The yardstick: the card's peaks, model FLOPs counted on the meta device,
and the least time of a kernel call from the bytes and operations its
algorithm needs.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates at the
700 W limit): 989 TFLOP/s in bfloat16, 495 TFLOP/s in TF32 (the yardstick
of a float32 cell: the flash kernels already run float32-accurate
attention on the tensor cores, 3xTF32), 3.35 TB/s of HBM3. A cell divides
by the peak of the precision its configuration states, whatever
implements the work, so a share reads the same work alike.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
HBM_BYTES_PER_S = 3.35e12
ELEM_BYTES = {"bfloat16": 2, "float32": 4}


def model_flops(fn: Callable[[], object]) -> int:
    """FLOPs of ``fn`` (a forward, or a forward and its backward, built on
    the meta device): two per multiply-add of every convolution and matrix
    product, nothing for elementwise work, no recomputation counted."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return counter.get_total_flops()


def least_time(nbytes: float, ops: float, dtype: str) -> Tuple[float, str]:
    """(seconds, what sets it): bytes over HBM bandwidth against
    operations over the precision's peak."""
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = ops / PEAK_FLOPS[dtype]
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def se_call(b: int, h: int, w: int, c: int, r: int, dtype: str) -> Dict:
    """Squeeze-excitation on x [b,h,w,c]: x read once, the scaled x written
    once, the two float32 weight matrices read once; the mean (one add per
    element), the two products (2*b*c*r each) and the scale (one multiply
    per element)."""
    n = b * h * w * c
    nbytes = 2 * n * ELEM_BYTES[dtype] + 2 * c * r * 4
    ops = 2 * n + 4 * b * c * r
    t, by = least_time(nbytes, ops, dtype)
    return {"bytes": nbytes, "ops": ops, "seconds": t, "bound_by": by}


def coord_attn_call(b: int, h: int, w: int, c: int, r: int,
                    dtype: str) -> Dict:
    """Coordinate attention on x [b,h,w,c]: x read once, the output written
    once, the float32 weights read once; both directional means (two adds
    per element), the bottleneck's 1x1 products over the h + w positions,
    and the weighting (three operations per element)."""
    n = b * h * w * c
    wts = 2 * c * r + 2 * r * r + 2 * r * c
    nbytes = 2 * n * ELEM_BYTES[dtype] + wts * 4
    ops = 5 * n + 2 * b * (h + w) * (c * r + r * r + r * c)
    t, by = least_time(nbytes, ops, dtype)
    return {"bytes": nbytes, "ops": ops, "seconds": t, "bound_by": by}


def flash_fwd_call(b: int, n: int, m: int, h: int, d: int,
                   dtype: str) -> Dict:
    """Attention forward, q [b,n,h,d], k and v [b,m,h,d]: q, k, v read
    once, o written once; S = QK^T and PV, two operations per
    multiply-add each."""
    e = ELEM_BYTES[dtype]
    nbytes = (2 * b * n * h * d + 2 * b * m * h * d) * e
    ops = 4 * b * h * n * m * d
    t, by = least_time(nbytes, ops, dtype)
    return {"bytes": nbytes, "ops": ops, "seconds": t, "bound_by": by}


def flash_bwd_call(b: int, n: int, m: int, h: int, d: int,
                   dtype: str) -> Dict:
    """Attention backward: q, o, dO and the row statistics read and dq
    written (n rows), k and v read and dk, dv written (m rows), once
    each; dV = P^T dO, dP = dO V^T, dQ = dS K and dK = dS^T Q. The S that
    the backward computes again is not counted."""
    e = ELEM_BYTES[dtype]
    nbytes = (4 * b * n * h * d + 4 * b * m * h * d + b * h * n) * e
    ops = 8 * b * h * n * m * d
    t, by = least_time(nbytes, ops, dtype)
    return {"bytes": nbytes, "ops": ops, "seconds": t, "bound_by": by}


CALLS = {"se": se_call, "coord_attn": coord_attn_call,
         "flash": flash_fwd_call, "flash_bwd": flash_bwd_call}


def sites_bound(sites: Dict, kind: str, dtype: str,
                call: str = None) -> float:
    """The summed least time in seconds of one forward's calls at the sites
    of ``kind`` (their shapes in ``sites[kind]``), counted by
    ``CALLS[call or kind]``."""
    return sum(CALLS[call or kind](*s, dtype)["seconds"]
               for s in sites[kind])

