"""The precision scheme of the flash-attention backward kernels, on the CPU.

The dQ and dK/dV kernels form every product on the tensor cores from TF32
operands (10 explicit mantissa bits). One TF32 product per fp32 product
is not accurate enough for the kernels' tolerance (1e-4 of max |reference|)
once the softmax is peaked; three of them (3xTF32: x = hi + lo, each
product lo·hi + hi·lo + hi·hi) are about as accurate as fp32, whether lo
is rounded to nearest or, as in the kernels, toward zero.
``flash_attention_backward_tf32`` forms the two passes' products that way
in plain torch, so these tests pin the choice without a card.

Tolerances, of max |reference|: 1e-5 for 3xTF32 against the fp32 twins
with standard-normal inputs; with q and k scaled by 3 the scores are 9x
larger, and the fp32 rounding of a score, which p = exp(s - L) turns into
a relative error, grows with them, so the bound is 1e-5 x 3² there (the
fp32 twin itself is ~1e-5 from a float64 twin at that scale).
"""

import numpy as np
import pytest
import torch

from diffusionmodel_tpu_torch.kernels.flash_attn import (
    HEAD_DIMS,
    flash_attention_backward_plain,
    flash_attention_backward_tf32,
    flash_attention_plain,
    tf32_round,
    tf32_split,
    tf32_truncate,
)

BWD_RTOL = 1e-4  # the kernels' tolerance on the card
N = 256  # N = M: seconds on the CPU


def _rel(got, want) -> float:
    return max(((g - w).abs().max() / w.abs().max()).item()
               for g, w in zip(got, want))


def _inputs(d: int, scale: float, seed: int = 0):
    rng = np.random.default_rng(seed + d)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((1, N, 2, d))
                                    .astype(np.float32)) for _ in range(4))
    q, k = q * scale, k * scale
    o, lse = flash_attention_plain(q, k, v, want_lse=True)
    return q, k, v, o, lse, do


def test_tf32_round_is_round_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10  # TF32 spacing in [1, 2)
    x = torch.tensor([one, one + ulp / 2, one + ulp / 2 - 2 ** -23,
                      one + 3 * ulp / 2, -(one + ulp / 2), 0.0, -0.0,
                      2.0 ** -130])
    want = torch.tensor([one, one + ulp, one, one + 2 * ulp, -(one + ulp),
                         0.0, -0.0, 2.0 ** -130])
    assert torch.equal(tf32_round(x), want)
    y = torch.from_numpy(np.random.default_rng(1).standard_normal(
        10_000).astype(np.float32)) * 1e3
    bits = tf32_round(y).view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())
    assert bool(((tf32_round(y) - y).abs() <= y.abs() * 2.0 ** -11).all())


def test_tf32_truncate_drops_the_low_bits():
    x = torch.tensor([1.0 + 2.0 ** -10 - 2.0 ** -23, -(1.0 + 2.0 ** -11), 3.0])
    assert torch.equal(tf32_truncate(x),
                       torch.tensor([1.0, -1.0, 3.0]))


@pytest.mark.parametrize("lo_round, bound", [("nearest", 2.0 ** -22),
                                             ("zero", 2.0 ** -21)])
@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e4])
def test_hi_plus_lo_reconstructs_fp32(scale, lo_round, bound):
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        100_000).astype(np.float32)) * scale
    hi, lo = tf32_split(x, lo_round)
    assert torch.equal(tf32_round(hi), hi) and torch.equal(tf32_round(lo), lo)
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= x.double().abs() * bound).all())


@pytest.mark.parametrize("lo_round", ["nearest", "zero"])
@pytest.mark.parametrize("scale", [1.0, 3.0])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_3xtf32_backward_matches_fp32_twins(d, scale, lo_round):
    args = _inputs(d, scale)
    got = flash_attention_backward_tf32(*args, passes=3, lo_round=lo_round)
    want = flash_attention_backward_plain(*args)
    assert all(g.shape == w.shape for g, w in zip(got, want))
    assert _rel(got, want) <= 1e-5 * scale ** 2


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_one_tf32_pass_misses_the_kernels_tolerance(d):
    """At q, k x3 one TF32 product per fp32 product misses BWD_RTOL: the
    reason the kernels take three."""
    args = _inputs(d, 3.0)
    one = flash_attention_backward_tf32(*args, passes=1)
    want = flash_attention_backward_plain(*args)
    assert _rel(one, want) > BWD_RTOL
    three = flash_attention_backward_tf32(*args, passes=3)
    assert _rel(three, want) < _rel(one, want) / 30


def test_tf32_emulation_refuses_other_pass_counts():
    with pytest.raises(ValueError, match="passes"):
        flash_attention_backward_tf32(*_inputs(16, 1.0), passes=2)
