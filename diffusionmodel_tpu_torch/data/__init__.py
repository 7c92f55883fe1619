"""Datasets of the port (numpy-only copies of ``diffusionmodel_tpu/data``
modules: importing anything from the JAX package pulls in jax)."""

from diffusionmodel_tpu_torch.data.crack_dataset import (  # noqa: F401
    CrackDataset,
    build_attn_mask,
    stratified_split,
)
from diffusionmodel_tpu_torch.data.loader import BatchLoader  # noqa: F401
