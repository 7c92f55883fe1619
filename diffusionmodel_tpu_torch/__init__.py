"""diffusionmodel_tpu_torch — the PyTorch/CUDA port of ``diffusionmodel_tpu``
for one NVIDIA H100.

The JAX package beside it is the reference: every ported module keeps its
counterpart's name and layout and is held to it by ``tests/test_torch_*.py``.
This package imports torch, numpy and the standard library only — never
jax, flax, optax or ``diffusionmodel_tpu``. Its SE, CoordAttn and
flash-attention kernels are CUDA C++ written for Hopper (``kernels/csrc``),
each beside a plain PyTorch twin used for CPU tensors. Entry points run on
the GPU unless the caller passes ``device="cpu"``.

Ported so far: the ContextUnet v2/v1 serving path (config, schedules,
layers, kernels, weight bridge, checkpoint reading, CFG samplers,
``SamplerService``, ``--mode serve``), the latent-diffusion inference and
training paths (``models.latent_diffusion``, ``--mode
txt2img|img2img|inpaint|train_ldm``), and the ContextUnet's training and
generation (``diffusion.train_loss``, ``train``, ``trainer.fit``,
``sample.gen_samples``, ``data``, checkpoint writing, ``--mode
train|generate``). See ROADMAP.md for the rest.
"""

__version__ = "0.1.0"

from diffusionmodel_tpu_torch.config import (  # noqa: F401
    Config,
    DiffusionConfig,
    ModelConfig,
    SampleConfig,
    TrainConfig,
    preset,
)
