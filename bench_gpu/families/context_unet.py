"""The ContextUnet family: the program's denoiser built from a
configuration file, its plain reference, and the shapes the yardstick
counts.

The program side takes the port's ``preset(file["preset"])`` and sets
every key of the file's ``model``, ``diffusion`` and ``train`` groups on
it, so the file is the configuration as it runs. Both sides get the same
seeded weights (``bench_gpu/weights.py``).
"""

from __future__ import annotations

from typing import Dict

import torch

from bench_gpu import roofline
from bench_gpu.reference import context_unet as ref
from bench_gpu.weights import fill_


def port_config(cfg: Dict, extra: Dict = None):
    """The port's Config: the preset with every key of the file's groups,
    then ``extra`` (dotted keys a traffic file sets, such as the
    sampler's depth)."""
    from diffusionmodel_tpu_torch.config import preset

    over = {f"{group}.{k}": (tuple(v) if isinstance(v, list) else v)
            for group in ("model", "diffusion", "train")
            for k, v in cfg[group].items()}
    over.update(extra or {})
    return preset(cfg["preset"], **over)


def build_program(cfg: Dict, seed: int, device, extra: Dict = None):
    """(port Config, the port's denoiser with the seeded weights, its
    schedule), on ``device``."""
    from diffusionmodel_tpu_torch.diffusion import Schedule
    from diffusionmodel_tpu_torch.nn.factory import build_model

    pc = port_config(cfg, extra)
    model = build_model(pc.model, pc.diffusion.high_thresh, device=device)
    fill_(model, seed)
    dc = pc.diffusion
    return pc, model, Schedule.create(dc.beta1, dc.beta2, dc.n_T, device)


def build_reference(cfg: Dict, seed: int, device) -> ref.ContextUnet:
    net = ref.build(cfg, device)
    fill_(net, seed)
    return net


def _meta_net(cfg: Dict) -> ref.ContextUnet:
    return ref.build(cfg, torch.device("meta"))


def _meta_inputs(cfg: Dict, b: int, mask: bool):
    m = cfg["model"]
    s = m["img_size"]
    kw = dict(device="meta")
    x = torch.zeros(b, s, s, m["in_ch"], **kw)
    c = torch.zeros(b, dtype=torch.long, **kw)
    t = torch.zeros(b, **kw)
    keep = torch.ones(b, **kw)
    am = torch.zeros(b, s, s, **kw) if mask else None
    return x, c, t, keep, am


def forward_flops(cfg: Dict, batch: int = 1) -> int:
    """Model FLOPs of one sampling forward (no spatial mask) at ``batch``."""
    net = _meta_net(cfg)
    args = _meta_inputs(cfg, batch, False)
    with torch.no_grad():
        return roofline.model_flops(lambda: net(*args))


def train_flops(cfg: Dict, batch: int = 1) -> int:
    """Model FLOPs of one training forward with the loss's spatial mask and
    its backward (parameter and input gradients), at ``batch``."""
    net = _meta_net(cfg)
    x, c, t, keep, am = _meta_inputs(cfg, batch, True)

    def fwd_bwd():
        net(x, c, t, keep, am).sum().backward()

    return roofline.model_flops(fwd_bwd)


def sites(cfg: Dict, batch: int) -> Dict:
    """Per sampling forward at ``batch``: the (b, h, w, c, r) of every SE
    and CoordAttn call, in call order."""
    net = _meta_net(cfg)
    found = {"se": [], "coord_attn": []}

    def hook(kind, red):
        def fn(mod, args):
            b, c, h, w = args[0].shape
            found[kind].append((b, h, w, c, red(c)))
        return fn

    red = lambda c: max(1, c // cfg["model"]["attn_reduction"])  # noqa: E731
    for m in net.modules():
        if isinstance(m, ref.SEBlock):
            m.register_forward_pre_hook(hook("se", red))
        elif isinstance(m, ref.CoordAttn):
            m.register_forward_pre_hook(hook("coord_attn", red))
    with torch.no_grad():
        net(*_meta_inputs(cfg, batch, False))
    return found
