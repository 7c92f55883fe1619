"""diffusionmodel_tpu_torch — the PyTorch/CUDA port of ``diffusionmodel_tpu``
for one NVIDIA H100.

The JAX package beside it is the reference: every ported module keeps its
counterpart's name and layout and is held to it by ``tests/test_torch_*.py``.
This package imports torch, numpy and the standard library only — never
jax, flax, optax or ``diffusionmodel_tpu``. Its SE, CoordAttn and
flash-attention kernels are CUDA C++ written for Hopper (``kernels/csrc``),
each beside a plain PyTorch twin used for CPU tensors. Entry points run on
the GPU unless the caller passes ``device="cpu"``.

Ported: the ContextUnet v2/v1 serving path (config, schedules, layers,
kernels, weight bridge, checkpoint reading and writing, CFG samplers,
``SamplerService``, ``--mode serve``), its training and generation
(``trainer.fit``, ``sample.gen_samples``, ``--mode train|generate``) and
editing (``sample.edit_samples``, ``--mode img2img|inpaint --family
main``), the side families (``nn.mnist_unet``, ``nn.cbam_unet``,
``models.annotated_ddpm`` with the textbook schedule), the
latent-diffusion inference and training paths with the CLIP text encoder
(``models.latent_diffusion``, ``--mode txt2img|img2img|inpaint|
train_ldm``), ``.pt`` checkpoints, and the quality metrics. Multi-device
training (mesh axes, ZeRO-1) is not: see ROADMAP.md.
"""

__version__ = "0.1.0"

import torch as _torch

# PyTorch's CPU exp (and log, tanh, erf ...) call MKL's vector math
# library, which sets itself up on its first call. When the first call
# is split across two threads, one of them can run before the setup is
# done and compute in a low-accuracy mode: exp off by up to 1.5e-4
# (relative) in that thread's half of the tensor, once per process (4 of
# 30 fresh processes with 2 threads on a Sapphire Rapids CPU). One call
# on one thread here finishes the setup before any op splits its work.
_torch.exp(_torch.zeros(8))

from diffusionmodel_tpu_torch.config import (  # noqa: F401
    Config,
    DiffusionConfig,
    ModelConfig,
    SampleConfig,
    TrainConfig,
    preset,
)
