"""JAX package parameter trees -> the port's ``state_dict``.

The inverse of ``diffusionmodel_tpu/compat/torch_convert.py::
convert_context_unet_v2``: the port's modules carry the reference's
``state_dict`` names, so that converter reads ``ContextUnet.state_dict()``
as it is, and this module maps the JAX package's flax trees (as numpy
arrays: a JAX checkpoint's ``params`` / ``batch_stats``) back onto those
names. Transforms:

- Conv kernel [kh,kw,I,O] -> Conv2d weight [O,I,kh,kw];
- Dense kernel [I,O] -> Linear weight [O,I];
- ConvTranspose kernel -> ConvTranspose2d weight [I,O,kh,kw]: the inverse
  of ``_convT``, which transposes AND flips the spatial axes (the flip is
  undone here once, not applied twice);
- GroupNorm / BatchNorm scale -> weight; BatchNorm statistics ->
  running_mean / running_var (``num_batches_tracked`` = 0).

Numpy only; the result is a dict of torch tensors for ``load_state_dict``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch


def _conv(k):
    return np.transpose(k, (3, 2, 0, 1))


def _conv_t(k):
    return np.transpose(np.asarray(k)[::-1, ::-1], (2, 3, 0, 1))


def _lin(k):
    return np.transpose(k, (1, 0))


class _Unmapper:
    def __init__(self, params: Dict[str, Any],
                 batch_stats: Optional[Dict[str, Any]]):
        self.params = params
        self.stats = batch_stats or {}
        self.sd: Dict[str, np.ndarray] = {}

    def _get(self, tree, path):
        node = tree
        for p in path:
            node = node[p]
        return node

    def conv(self, fpath, tkey, transposed=False):
        node = self._get(self.params, fpath)
        k = np.asarray(node["kernel"])
        self.sd[f"{tkey}.weight"] = _conv_t(k) if transposed else _conv(k)
        if "bias" in node:
            self.sd[f"{tkey}.bias"] = np.asarray(node["bias"])

    def dense(self, fpath, tkey):
        node = self._get(self.params, fpath)
        self.sd[f"{tkey}.weight"] = _lin(np.asarray(node["kernel"]))
        if "bias" in node:
            self.sd[f"{tkey}.bias"] = np.asarray(node["bias"])

    def gn(self, fpath, tkey):
        node = self._get(self.params, fpath)
        self.sd[f"{tkey}.weight"] = np.asarray(node["scale"])
        self.sd[f"{tkey}.bias"] = np.asarray(node["bias"])

    def bn(self, fpath, tkey):
        self.gn(fpath, tkey)
        st = self._get(self.stats, fpath)
        self.sd[f"{tkey}.running_mean"] = np.asarray(st["mean"])
        self.sd[f"{tkey}.running_var"] = np.asarray(st["var"])
        self.sd[f"{tkey}.num_batches_tracked"] = np.zeros((), np.int64)

    def norm(self, fpath, tkey):
        """The JAX ``Norm`` wrapper holds BatchNorm_0 or GroupNorm_0."""
        node = self._get(self.params, fpath)
        if "BatchNorm_0" in node:
            self.bn(fpath + ("BatchNorm_0",), tkey)
        else:
            self.gn(fpath + ("GroupNorm_0",), tkey)

    def resconv(self, fpath, tkey):
        self.conv(fpath + ("Conv_0",), f"{tkey}.conv1.0")
        self.norm(fpath + ("Norm_0",), f"{tkey}.conv1.1")
        self.conv(fpath + ("Conv_1",), f"{tkey}.conv2.0")
        self.norm(fpath + ("Norm_1",), f"{tkey}.conv2.1")
        if "SEBlock_0" in self._get(self.params, fpath):
            self.dense(fpath + ("SEBlock_0", "Dense_0"), f"{tkey}.se.fc.0")
            self.dense(fpath + ("SEBlock_0", "Dense_1"), f"{tkey}.se.fc.2")

    def embed_fc(self, fpath, tkey):
        self.dense(fpath + ("Dense_0",), f"{tkey}.model.0")
        self.dense(fpath + ("Dense_1",), f"{tkey}.model.2")

    def unet_down(self, fpath, tkey):
        self.conv(fpath + ("Conv_0",), f"{tkey}.channel_compress.0")
        self.norm(fpath + ("Norm_0",), f"{tkey}.channel_compress.1")
        self.conv(fpath + ("Conv_1",), f"{tkey}.ch_adjust")
        self.conv(fpath + ("Conv_2",), f"{tkey}.down.0")
        self.norm(fpath + ("Norm_1",), f"{tkey}.down.1")
        self.resconv(fpath + ("ResConvBlock_0",), f"{tkey}.down.3")
        self.conv(fpath + ("Conv_3",), f"{tkey}.down.4")

    def unet_up(self, fpath, tkey):
        self.conv(fpath + ("Conv_0",), f"{tkey}.model.0.1")
        self.resconv(fpath + ("ResConvBlock_0",), f"{tkey}.model.1")
        self.resconv(fpath + ("ResConvBlock_1",), f"{tkey}.model.2")

    def coord_attn(self, fpath, tkey):
        for name in ("conv1_h", "conv1_w", "h2w_proj", "w2h_proj", "conv_h",
                     "conv_w"):
            self.conv(fpath + (name,), f"{tkey}.{name}")
        self.norm(fpath + ("bn1_h",), f"{tkey}.bn1_h")
        self.norm(fpath + ("bn1_w",), f"{tkey}.bn1_w")
        node = self._get(self.params, fpath)
        for s in ("gamma_h", "gamma_w", "alpha", "beta"):
            self.sd[f"{tkey}.{s}"] = np.asarray(node[s])


def state_dict_from_flax(params: Dict[str, Any],
                         batch_stats: Optional[Dict[str, Any]] = None
                         ) -> Dict[str, torch.Tensor]:
    """A JAX ContextUnet (v2 or v1) parameter tree -> the port's
    ``state_dict``. ``batch_stats`` is required for ``norm="batch"``."""
    m = _Unmapper(params, batch_stats)
    m.resconv(("init_conv",), "init_conv")
    for i in range(1, 5):
        m.unet_down((f"down{i}",), f"down{i}")
        if f"ca{i}" in params:
            m.coord_attn((f"ca{i}",), f"ca{i}")
    for name in ("time_emb1", "time_emb2", "ctx_emb1", "ctx_emb2"):
        m.embed_fc((name,), name)
    m.conv(("up0_convt",), "up0.0", transposed=True)
    m.gn(("up0_gn",), "up0.1")
    for i in range(1, 5):
        m.unet_up((f"up{i}",), f"up{i}")
    if "local_enhance" in params:
        m.conv(("local_enhance", "Conv_0"), "local_enhance.conv.0")
        m.gn(("local_enhance", "GroupNorm_0"), "local_enhance.conv.1")
        m.conv(("local_enhance", "Conv_1"), "local_enhance.conv.3")
    m.conv(("out_conv1",), "out.0")
    m.gn(("out_gn",), "out.1")
    m.conv(("out_conv2",), "out.3")
    return {k: torch.from_numpy(np.copy(v, order="C"))
            for k, v in m.sd.items()}
