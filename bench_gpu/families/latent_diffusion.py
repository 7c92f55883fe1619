"""The latent-diffusion family: the port's ``LdmRunner`` built from a
configuration file, the plain reference stack, and the shapes the
yardstick counts.

The UNet and the VAE each get their own seeded weights
(``bench_gpu/weights.py``), the same on both sides.
"""

from __future__ import annotations

from typing import Dict

import torch

from bench_gpu import roofline
from bench_gpu.reference import latent_diffusion as ref
from bench_gpu.weights import derive, fill_


def _fill(unet, ae, seed: int) -> None:
    fill_(unet, derive(seed, 11))
    fill_(ae, derive(seed, 12))


def build_program(cfg: Dict, seed: int, device, sampler: str = "dpmpp",
                  steps: int = 20):
    """The port's runner with the seeded weights, conditioned through its
    prompt hash (no CLIP cache is looked for)."""
    from diffusionmodel_tpu_torch.models.latent_diffusion.runner import (
        LdmRunner,
    )

    runner = LdmRunner(arch=cfg["arch"], use_flash=cfg["use_flash"],
                       sampler=sampler, steps=steps, verbose=False,
                       device=device, use_clip=False)
    _fill(runner.unet, runner.ae, seed)
    return runner


def build_reference(cfg: Dict, seed: int, device) -> ref.Stack:
    with torch.device(device):
        stack = ref.Stack(cfg)
    _fill(stack.unet, stack.ae, seed)
    return stack


def _latent(cfg: Dict) -> int:
    return cfg["image_size"] // 8


def _meta_unet_call(cfg: Dict, b: int):
    with torch.device("meta"):
        stack = ref.Stack(cfg)
    s, u = _latent(cfg), cfg["unet"]
    x = torch.zeros(b, s, s, u["in_channels"], device="meta")
    t = torch.zeros(b, dtype=torch.long, device="meta")
    c = torch.zeros(b, 77, u["d_cond"], device="meta")
    return stack, (x, t, c)


def unet_flops(cfg: Dict, batch: int = 1) -> int:
    stack, args = _meta_unet_call(cfg, batch)
    with torch.no_grad():
        return roofline.model_flops(lambda: stack.unet(*args))


def decode_flops(cfg: Dict, batch: int = 1) -> int:
    stack, _ = _meta_unet_call(cfg, batch)
    s = _latent(cfg)
    z = torch.zeros(batch, s, s, cfg["autoencoder"]["z_channels"],
                    device="meta")
    with torch.no_grad():
        return roofline.model_flops(lambda: stack.ae.decode(z))


def unet_train_flops(cfg: Dict, batch: int = 1) -> int:
    """One training forward of the UNet and its backward."""
    stack, args = _meta_unet_call(cfg, batch)
    return roofline.model_flops(
        lambda: stack.unet(*args).sum().backward())


def sites(cfg: Dict, batch: int) -> Dict:
    """Per UNet call at ``batch``: the (b, n, m, h, d) of every
    self-attention at or above the flash gate, in call order."""
    stack, args = _meta_unet_call(cfg, batch)
    gate = cfg["unet"]["flash_min_seq"]
    found = []

    def hook(mod, a, kw=None):
        x = a[0]
        if len(a) == 1 and x.shape[1] >= gate:  # self-attention
            found.append((x.shape[0], x.shape[1], x.shape[1], mod.heads,
                          mod.d_head))

    for m in stack.unet.modules():
        if isinstance(m, ref.CrossAttention):
            m.register_forward_pre_hook(hook)
    with torch.no_grad():
        stack.unet(*args)
    return {"flash": found}
