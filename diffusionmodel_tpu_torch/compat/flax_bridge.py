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


# --- latent diffusion: flax trees -> SD-v1 names ---------------------------
#
# The port's LDM modules carry the SD-v1 checkpoint's names, so these are
# the inverse of ``diffusionmodel_tpu/compat/sd_convert.py``
# (``convert_sd_unet`` / ``convert_sd_autoencoder``): the same
# (flax path, SD key, kind) rules, kept here as the port's own copy.

def ldm_unet_rules(channel_multipliers=(1, 2, 4, 4),
                   attention_levels=(0, 1, 2), n_res_blocks: int = 2,
                   tf_layers: int = 1):
    """(flax path, SD key, kind) for every parameterised layer of the LDM
    UNet; kind is conv, dense, dense_nobias or norm."""
    rules = []

    def resblock(fp, tk):
        rules.extend([
            (fp + ("in_norm",), f"{tk}.in_layers.0", "norm"),
            (fp + ("in_conv",), f"{tk}.in_layers.2", "conv"),
            (fp + ("emb",), f"{tk}.emb_layers.1", "dense"),
            (fp + ("out_norm",), f"{tk}.out_layers.0", "norm"),
            (fp + ("out_conv",), f"{tk}.out_layers.3", "conv"),
            (fp + ("skip",), f"{tk}.skip_connection", "conv")])

    def transformer(fp, tk):
        rules.append((fp + ("norm",), f"{tk}.norm", "norm"))
        rules.append((fp + ("proj_in",), f"{tk}.proj_in", "conv"))
        for i in range(tf_layers):
            bf, bt = fp + (f"block_{i}",), f"{tk}.transformer_blocks.{i}"
            for attn in ("attn1", "attn2"):
                for qkv in ("to_q", "to_k", "to_v"):
                    rules.append((bf + (attn, qkv), f"{bt}.{attn}.{qkv}",
                                  "dense_nobias"))
                rules.append((bf + (attn, "to_out"), f"{bt}.{attn}.to_out.0",
                              "dense"))
            for n in (1, 2, 3):
                rules.append((bf + (f"norm{n}",), f"{bt}.norm{n}", "norm"))
            rules.append((bf + ("geglu", "proj"), f"{bt}.ff.net.0.proj",
                          "dense"))
            rules.append((bf + ("ff_out",), f"{bt}.ff.net.2", "dense"))
        rules.append((fp + ("proj_out",), f"{tk}.proj_out", "conv"))

    rules.append((("time_0",), "time_embed.0", "dense"))
    rules.append((("time_2",), "time_embed.2", "dense"))
    rules.append((("in_conv",), "input_blocks.0.0", "conv"))
    n_levels = len(channel_multipliers)
    idx = 1
    for i in range(n_levels):
        for j in range(n_res_blocks):
            resblock((f"down_{i}_{j}_res",), f"input_blocks.{idx}.0")
            if i in attention_levels:
                transformer((f"down_{i}_{j}_attn",), f"input_blocks.{idx}.1")
            idx += 1
        if i != n_levels - 1:
            rules.append(((f"down_{i}_downsample",),
                          f"input_blocks.{idx}.0.op", "conv"))
            idx += 1
    resblock(("mid_res1",), "middle_block.0")
    transformer(("mid_attn",), "middle_block.1")
    resblock(("mid_res2",), "middle_block.2")
    idx = 0
    for i in reversed(range(n_levels)):
        for j in range(n_res_blocks + 1):
            resblock((f"up_{i}_{j}_res",), f"output_blocks.{idx}.0")
            if i in attention_levels:
                transformer((f"up_{i}_{j}_attn",), f"output_blocks.{idx}.1")
            if i != 0 and j == n_res_blocks:
                sub = 2 if i in attention_levels else 1
                rules.append(((f"up_{i}_upsample",),
                              f"output_blocks.{idx}.{sub}.conv", "conv"))
            idx += 1
    rules.append((("out_norm",), "out.0", "norm"))
    rules.append((("out_conv",), "out.2", "conv"))
    return rules


def autoencoder_rules(ch_mults=(1, 2, 4, 4), n_resnet: int = 2):
    """(flax path, SD key, kind) for every layer of the LDM autoencoder."""
    rules = []

    def resnet(fp, tk):
        rules.extend([
            (fp + ("GroupNorm_0",), f"{tk}.norm1", "norm"),
            (fp + ("conv1",), f"{tk}.conv1", "conv"),
            (fp + ("GroupNorm_1",), f"{tk}.norm2", "norm"),
            (fp + ("conv2",), f"{tk}.conv2", "conv"),
            (fp + ("nin_shortcut",), f"{tk}.nin_shortcut", "conv")])

    def attn(fp, tk):
        rules.append((fp + ("norm",), f"{tk}.norm", "norm"))
        for n in ("q", "k", "v", "proj_out"):
            rules.append((fp + (n,), f"{tk}.{n}", "conv"))

    n_levels = len(ch_mults)
    rules.append((("encoder", "conv_in"), "encoder.conv_in", "conv"))
    for i in range(n_levels):
        for j in range(n_resnet):
            resnet(("encoder", f"down_{i}_block_{j}"),
                   f"encoder.down.{i}.block.{j}")
        if i != n_levels - 1:
            rules.append((("encoder", f"down_{i}_downsample"),
                          f"encoder.down.{i}.downsample.conv", "conv"))
    resnet(("encoder", "mid_block_1"), "encoder.mid.block_1")
    attn(("encoder", "mid_attn"), "encoder.mid.attn_1")
    resnet(("encoder", "mid_block_2"), "encoder.mid.block_2")
    rules.append((("encoder", "norm_out"), "encoder.norm_out", "norm"))
    rules.append((("encoder", "conv_out"), "encoder.conv_out", "conv"))
    rules.append((("decoder", "conv_in"), "decoder.conv_in", "conv"))
    resnet(("decoder", "mid_block_1"), "decoder.mid.block_1")
    attn(("decoder", "mid_attn"), "decoder.mid.attn_1")
    resnet(("decoder", "mid_block_2"), "decoder.mid.block_2")
    for i in range(n_levels):
        for j in range(n_resnet + 1):
            resnet(("decoder", f"up_{i}_block_{j}"),
                   f"decoder.up.{i}.block.{j}")
        if i != 0:
            rules.append((("decoder", f"up_{i}_upsample"),
                          f"decoder.up.{i}.upsample.conv", "conv"))
    rules.append((("decoder", "norm_out"), "decoder.norm_out", "norm"))
    rules.append((("decoder", "conv_out"), "decoder.conv_out", "conv"))
    rules.append((("quant_conv",), "quant_conv", "conv"))
    rules.append((("post_quant_conv",), "post_quant_conv", "conv"))
    return rules


def _from_rules(tree: Dict[str, Any], rules) -> Dict[str, torch.Tensor]:
    """Apply (flax path, key, kind) rules to a flax tree; a path the tree
    lacks (an optional skip / shortcut conv) is left out."""
    sd: Dict[str, np.ndarray] = {}
    for fpath, tkey, kind in rules:
        node = tree
        for p in fpath:
            node = node.get(p) if isinstance(node, dict) else None
        if node is None:
            continue
        if kind == "norm":
            sd[f"{tkey}.weight"] = np.asarray(node["scale"])
            sd[f"{tkey}.bias"] = np.asarray(node["bias"])
            continue
        k = np.asarray(node["kernel"])
        sd[f"{tkey}.weight"] = _conv(k) if kind == "conv" else _lin(k)
        if kind != "dense_nobias" and "bias" in node:
            sd[f"{tkey}.bias"] = np.asarray(node["bias"])
    return {k: torch.from_numpy(np.array(v, np.float32, order="C"))
            for k, v in sd.items()}


def ldm_unet_state_dict_from_flax(params: Dict[str, Any],
                                  channel_multipliers=(1, 2, 4, 4),
                                  attention_levels=(0, 1, 2),
                                  n_res_blocks: int = 2, tf_layers: int = 1
                                  ) -> Dict[str, torch.Tensor]:
    """A JAX ``UNetModel`` parameter tree -> the port's ``UNetModel``
    state_dict (SD-v1 names, no prefix)."""
    return _from_rules(params, ldm_unet_rules(
        channel_multipliers, attention_levels, n_res_blocks, tf_layers))


def autoencoder_state_dict_from_flax(params: Dict[str, Any],
                                     ch_mults=(1, 2, 4, 4),
                                     n_resnet: int = 2
                                     ) -> Dict[str, torch.Tensor]:
    """A JAX ``Autoencoder`` parameter tree -> the port's ``Autoencoder``
    state_dict (SD-v1 names, no prefix)."""
    return _from_rules(params, autoencoder_rules(ch_mults, n_resnet))
