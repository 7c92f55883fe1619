"""InceptionV3 feature extractor for FID (counterpart of
``diffusionmodel_tpu/metrics/inception.py``).

torchvision's inception_v3 trunk to the pooled 2048-d features the
reference takes (new_scripy.py:1120-1127), with torchvision's state_dict
names (``Conv2d_1a_3x3.conv.weight``, ``Mixed_5b.branch1x1.bn.running_var``,
...), so a torchvision state dict loads as it is and the JAX package's
``convert_torchvision_inception`` maps ``state_dict()`` onto its flax tree.

Semantics pinned by the JAX module and kept here:

- BatchNorm with eps 1e-3, in inference mode (running statistics);
- the pools inside the blocks are ``avg_pool2d(3, 1, 1)`` dividing by the
  full window (``count_include_pad=True``) and ``max_pool2d(3, 2)`` without
  padding;
- ``transform_input=False`` and inputs in [0, 1] without ImageNet
  normalisation (new_scripy.py:1134-1143);
- the mean over H and W to 2048 values (the fc is stripped).

Inputs are NHWC ``[B, 299, 299, 3]``, as the JAX module takes them. The
convolutions are PyTorch's (cuDNN on the card): no Pallas kernel computes
them in the JAX package either.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


class BasicConv2d(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel_size, stride: int = 1,
                 padding=0):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel_size, stride=stride,
                              padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(out_ch, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avgpool3(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


def _maxpool3s2(x):
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 64, 1)
        self.branch5x5_1 = BasicConv2d(in_ch, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(in_ch, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3,
                          self.branch_pool(_avgpool3(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _maxpool3s2(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for m in (self.branch7x7dbl_2, self.branch7x7dbl_3,
                  self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = m(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(_avgpool3(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for m in (self.branch7x7x3_2, self.branch7x7x3_3,
                  self.branch7x7x3_4):
            b7 = m(b7)
        return torch.cat([b3, b7, _maxpool3s2(x)], 1)


class InceptionE(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 320, 1)
        self.branch3x3_1 = BasicConv2d(in_ch, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       1)
        return torch.cat([self.branch1x1(x), b3, bd,
                          self.branch_pool(_avgpool3(x))], 1)


class InceptionV3Features(nn.Module):
    """Trunk to pooled 2048-d features: NHWC ``[B, H, W, 3]`` in [0, 1]
    (299 px for the reference's use; at least 75 px) -> ``[B, 2048]``."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _maxpool3s2(x)
        x = _maxpool3s2(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)))
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))  # adaptive average pool -> [B, 2048]


# flax's lecun_normal: a normal truncated to [-2, 2] standard deviations,
# rescaled by this constant so that the truncated draw keeps variance
# 1 / fan_in (jax.nn.initializers.variance_scaling, "truncated_normal").
_TRUNC_STD = 0.87962566103423978


def proxy_inception(seed: int = 42, device=None) -> InceptionV3Features:
    """The proxy extractor's trunk: random weights from a seeded CPU
    ``torch.Generator``, drawn from the distributions the JAX package's
    ``_default_feature_fn`` uses (flax's ``lecun_normal`` -- a normal
    truncated to [-2, 2] with std ``sqrt(1/fan_in)/0.8796`` -- then x sqrt 2 on
    every conv kernel, He scaling; BatchNorm at scale 1, bias 0, mean 0,
    var 1), moved to ``device`` in eval mode.

    The JAX package draws them from ``jax.random.PRNGKey(42)`` (threefry),
    which torch cannot reproduce: proxy scores are comparable within one
    package, never between the two. Compare the packages through
    ``--inception_weights``, where both load the same file."""
    model = InceptionV3Features()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                w = m.weight
                fan_in = w.shape[1] * w.shape[2] * w.shape[3]
                nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=g)
                w.mul_((1.0 / fan_in) ** 0.5 / _TRUNC_STD * 2.0 ** 0.5)
    return model.to(device).eval()


def load_inception_state_dict(weights_path: str) -> Dict[str, torch.Tensor]:
    """A torchvision inception_v3 state dict from an ``.npz`` (name ->
    array) or a ``.pt`` / ``.pth`` file holding a state dict, read with
    ``torch.load(..., weights_only=True)``. A pickled whole torchvision
    module is not read: unpickling it needs torchvision; save its
    ``state_dict()`` instead. The fc and AuxLogits entries are dropped."""
    if weights_path.endswith(".npz"):
        with np.load(weights_path) as f:
            sd = {k: torch.from_numpy(np.array(f[k])) for k in f.files}
    else:
        sd = torch.load(weights_path, map_location="cpu", weights_only=True)
        if not isinstance(sd, dict):
            raise ValueError(f"{weights_path} does not hold a state dict")
    return {k: torch.as_tensor(v) for k, v in sd.items()
            if not k.startswith(("fc.", "AuxLogits."))}


def load_inception(weights_path: str, device=None) -> InceptionV3Features:
    """The trunk with the weights of ``weights_path`` (see
    :func:`load_inception_state_dict`), on ``device`` in eval mode. Every
    trunk entry must be present (``num_batches_tracked`` may be absent)."""
    model = InceptionV3Features()
    missing, unexpected = model.load_state_dict(
        load_inception_state_dict(weights_path), strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError(f"{weights_path} is not an inception_v3 state "
                         f"dict: missing {missing[:5]}, unexpected "
                         f"{unexpected[:5]}")
    return model.to(device).eval()
