"""The SDXL family: the port's ``LdmRunner`` of the ``sdxl`` arch built
from a configuration file, the plain reference stack
(``bench_gpu/reference/sdxl.py``), and the shapes the yardstick counts,
the vector condition y included.

The UNet and the VAE each get their own seeded weights
(``bench_gpu/weights.py``), the same on both sides.
"""

from __future__ import annotations

from typing import Dict

import torch

from bench_gpu import roofline
from bench_gpu.families.latent_diffusion import build_program  # noqa: F401
from bench_gpu.reference import sdxl as ref
from bench_gpu.weights import derive, fill_


def build_reference(cfg: Dict, seed: int, device) -> ref.Stack:
    with torch.device(device):
        stack = ref.Stack(cfg)
    fill_(stack.unet, derive(seed, 11))
    fill_(stack.ae, derive(seed, 12))
    return stack


def _meta_unet_call(cfg: Dict, b: int):
    with torch.device("meta"):
        stack = ref.Stack(cfg)
    s, u = cfg["image_size"] // 8, cfg["unet"]
    x = torch.zeros(b, s, s, u["in_channels"], device="meta")
    t = torch.zeros(b, dtype=torch.long, device="meta")
    c = torch.zeros(b, 77, u["context_dim"], device="meta")
    y = torch.zeros(b, u["adm_in_channels"], device="meta")
    return stack, (x, t, (c, y))


def unet_flops(cfg: Dict, batch: int = 1) -> int:
    stack, args = _meta_unet_call(cfg, batch)
    with torch.no_grad():
        return roofline.model_flops(lambda: stack.unet(*args))


def decode_flops(cfg: Dict, batch: int = 1) -> int:
    stack, _ = _meta_unet_call(cfg, batch)
    s = cfg["image_size"] // 8
    z = torch.zeros(batch, s, s, cfg["autoencoder"]["z_channels"],
                    device="meta")
    with torch.no_grad():
        return roofline.model_flops(lambda: stack.ae.decode(z))


def sites(cfg: Dict, batch: int) -> Dict:
    """Per UNet call at ``batch``: the (b, n, m, h, d) of every
    self-attention at or above the flash gate, in call order."""
    stack, args = _meta_unet_call(cfg, batch)
    gate = cfg["unet"]["flash_min_seq"]
    found = []

    def hook(mod, a):
        x = a[0]
        if len(a) == 1 and x.shape[1] >= gate:  # self-attention
            found.append((x.shape[0], x.shape[1], x.shape[1], mod.heads,
                          mod.d_head))

    for m in stack.unet.modules():
        if isinstance(m, ref.sd.CrossAttention):
            m.register_forward_pre_hook(hook)
    with torch.no_grad():
        stack.unet(*args)
    return {"flash": found}
