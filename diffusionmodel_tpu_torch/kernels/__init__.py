"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch twin.

- ``se_block``: squeeze-excitation (replaces the Pallas ``se_block_fused``);
- ``coord_attn``: coordinate attention (replaces ``coord_attn_fused``);
- ``flash_attn``: the flash-attention forward (replaces ``_flash_forward``);
- ``flash_attn_bwd``: its two backward passes (replace ``_flash_dq_kernel``
  and ``_flash_dkv_kernel``), behind ``flash_attn.FlashAttentionFunction``;
- ``group_norm``: GroupNorm + activation in bf16 (replaces no TPU kernel:
  XLA fuses it there), reached from ``nn.blocks.GroupNorm`` in inference.

Sources live in ``csrc/`` and are built by ``_build`` at first use.
"""

import torch

from diffusionmodel_tpu_torch import tracing


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


def per_sample_conv(conv, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)``; for a bf16 ``x`` without gradients (inference), one
    call per sample.

    cuDNN's bf16 kernels on Hopper split some shapes' work unevenly over
    the batch (six of the flagship's convolutions, on its 32x32 maps at
    batch 16), so a sample's sums, and their rounding, would depend on
    where it sits in the batch, and a seed-pinned request would change
    with its batch neighbours (``SamplerService``'s contract, as for
    :func:`per_sample_matmul`). One call per sample costs 9-10% of a
    batch-16 bf16 forward: 202.2-203.9 ms against 184.9-186.3 ms on an
    NVIDIA H100 at 700 W (``tools/bf16_batch_invariance_probe.py``, two
    runs; ``chip_smoke.py``'s ``forward_bf16`` checks the invariance).
    float32 convolutions were invariant already, and training keeps one
    call for the batch. With ``tracing`` on, a call that splits adds its
    batch size to the counter ``conv.per_sample_calls``."""
    if x.dtype == torch.float32 or torch.is_grad_enabled() \
            or x.shape[0] == 1:
        return conv(x)
    tracing.count("conv.per_sample_calls", x.shape[0])
    return torch.cat([conv(s) for s in x.split(1)])
