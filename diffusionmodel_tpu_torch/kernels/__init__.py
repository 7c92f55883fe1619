"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch twin.

- ``se_block``: squeeze-excitation (replaces the Pallas ``se_block_fused``);
- ``coord_attn``: coordinate attention (replaces ``coord_attn_fused``);
- ``flash_attn``: the flash-attention forward (replaces ``_flash_forward``).

Sources live in ``csrc/`` and are built by ``_build`` at first use.
"""

import torch


def per_sample_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` for a: [B, ..., K], w: [K, N], one product per sample.

    A single GEMM over the flattened batch may sum a row in an order that
    depends on where the row sits (the CPU's BLAS does), which would let
    batch neighbours move a sample's result; a batched product of one
    matrix per sample cannot. The serving contract needs that."""
    b = a.shape[0]
    rows = a.reshape(b, -1, a.shape[-1])
    out = torch.bmm(rows, w.expand(b, *w.shape))
    return out.reshape(*a.shape[:-1], w.shape[-1])
