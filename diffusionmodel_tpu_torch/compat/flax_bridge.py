"""JAX package parameter trees <-> the port's ``state_dict``.

The inverse of ``diffusionmodel_tpu/compat/torch_convert.py``'s
converters (``convert_context_unet_v2``, ``convert_mnist_unet``,
``convert_cbam_unet``): the port's modules carry the reference's
``state_dict`` names, so those converters read the port's
``state_dict()`` as it is, and this module maps the JAX package's flax
trees (as numpy arrays: a JAX checkpoint's ``params`` / ``batch_stats``)
back onto those names, one walk per arch. The labml U-Net
(``ddpm_unet``), which has no converter there, goes through rules
(``ddpm_unet_rules``) in both directions, as the LDM modules do.
Transforms:

- Conv kernel [kh,kw,I,O] -> Conv2d weight [O,I,kh,kw];
- Dense kernel [I,O] -> Linear weight [O,I];
- ConvTranspose kernel -> ConvTranspose2d weight [I,O,kh,kw]: the inverse
  of ``_convT``, which transposes AND flips the spatial axes (the flip is
  undone here once, not applied twice);
- GroupNorm / BatchNorm scale -> weight; BatchNorm statistics ->
  running_mean / running_var (``num_batches_tracked`` = 0).

``flax_from_state_dict`` walks the same layer paths the other way, so a
checkpoint the port writes holds the JAX package's trees.

Numpy only; ``state_dict_from_flax`` gives torch tensors for
``load_state_dict``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _conv(k):
    return np.transpose(k, (3, 2, 0, 1))


def _conv_t(k):
    return np.transpose(np.asarray(k)[::-1, ::-1], (2, 3, 0, 1))


def _lin(k):
    return np.transpose(k, (1, 0))


class _Unmapper:
    """Walks the ContextUnet's layers (:func:`_walk_context_unet`) reading
    a flax tree into ``state_dict`` names. :class:`_Mapper` walks the same
    paths the other way."""

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

    # which optional layers the network has
    def has(self, fpath, tkey) -> bool:
        return fpath[-1] in self._get(self.params, fpath[:-1])

    def is_bn(self, fpath, tkey) -> bool:
        """The JAX ``Norm`` wrapper holds BatchNorm_0 or GroupNorm_0."""
        return "BatchNorm_0" in self._get(self.params, fpath)

    # leaves
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

    def scalar(self, fpath, tkey):
        self.sd[tkey] = np.asarray(self._get(self.params, fpath))

    # composites
    def norm(self, fpath, tkey):
        if self.is_bn(fpath, tkey):
            self.bn(fpath + ("BatchNorm_0",), tkey)
        else:
            self.gn(fpath + ("GroupNorm_0",), tkey)

    def resconv(self, fpath, tkey):
        self.conv(fpath + ("Conv_0",), f"{tkey}.conv1.0")
        self.norm(fpath + ("Norm_0",), f"{tkey}.conv1.1")
        self.conv(fpath + ("Conv_1",), f"{tkey}.conv2.0")
        self.norm(fpath + ("Norm_1",), f"{tkey}.conv2.1")
        if self.has(fpath + ("SEBlock_0",), f"{tkey}.se"):
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
        for s in ("gamma_h", "gamma_w", "alpha", "beta"):
            self.scalar(fpath + (s,), f"{tkey}.{s}")


class _Mapper(_Unmapper):
    """The same walk from a ``state_dict`` (numpy arrays) to flax trees:
    ``params`` and ``batch_stats``."""

    def __init__(self, sd: Dict[str, np.ndarray]):
        super().__init__({}, {})
        self.sd = sd

    def _put(self, tree, fpath, leaf, value):
        node = tree
        for p in fpath:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(value)

    def has(self, fpath, tkey) -> bool:
        return any(k.startswith(tkey + ".") for k in self.sd)

    def is_bn(self, fpath, tkey) -> bool:
        return f"{tkey}.running_mean" in self.sd

    def conv(self, fpath, tkey, transposed=False):
        w = self.sd[f"{tkey}.weight"]
        # inverse of _conv_t: [I,O,kh,kw] -> [kh,kw,I,O], spatially flipped
        k = (np.transpose(w, (2, 3, 0, 1))[::-1, ::-1] if transposed
             else np.transpose(w, (2, 3, 1, 0)))
        self._put(self.params, fpath, "kernel", k)
        if f"{tkey}.bias" in self.sd:
            self._put(self.params, fpath, "bias", self.sd[f"{tkey}.bias"])

    def dense(self, fpath, tkey):
        self._put(self.params, fpath, "kernel",
                  _lin(self.sd[f"{tkey}.weight"]))
        if f"{tkey}.bias" in self.sd:
            self._put(self.params, fpath, "bias", self.sd[f"{tkey}.bias"])

    def gn(self, fpath, tkey):
        self._put(self.params, fpath, "scale", self.sd[f"{tkey}.weight"])
        self._put(self.params, fpath, "bias", self.sd[f"{tkey}.bias"])

    def bn(self, fpath, tkey):
        self.gn(fpath, tkey)
        self._put(self.stats, fpath, "mean", self.sd[f"{tkey}.running_mean"])
        self._put(self.stats, fpath, "var", self.sd[f"{tkey}.running_var"])

    def scalar(self, fpath, tkey):
        self._put(self.params, fpath[:-1], fpath[-1], self.sd[tkey])


def _walk_context_unet(m: _Unmapper) -> None:
    m.resconv(("init_conv",), "init_conv")
    for i in range(1, 5):
        m.unet_down((f"down{i}",), f"down{i}")
        if m.has((f"ca{i}",), f"ca{i}"):
            m.coord_attn((f"ca{i}",), f"ca{i}")
    for name in ("time_emb1", "time_emb2", "ctx_emb1", "ctx_emb2"):
        m.embed_fc((name,), name)
    m.conv(("up0_convt",), "up0.0", transposed=True)
    m.gn(("up0_gn",), "up0.1")
    for i in range(1, 5):
        m.unet_up((f"up{i}",), f"up{i}")
    if m.has(("local_enhance",), "local_enhance"):
        m.conv(("local_enhance", "Conv_0"), "local_enhance.conv.0")
        m.gn(("local_enhance", "GroupNorm_0"), "local_enhance.conv.1")
        m.conv(("local_enhance", "Conv_1"), "local_enhance.conv.3")
    m.conv(("out_conv1",), "out.0")
    m.gn(("out_gn",), "out.1")
    m.conv(("out_conv2",), "out.3")


def _walk_mnist_unet(m: _Unmapper) -> None:
    """MNIST_script.py's names (torch_convert.convert_mnist_unet)."""
    m.resconv(("init_conv",), "init_conv")
    m.resconv(("down1_res",), "down1.model.0")
    m.resconv(("down2_res",), "down2.model.0")
    for name in ("timeembed1", "timeembed2", "contextembed1",
                 "contextembed2"):
        m.embed_fc((name,), name)
    m.conv(("up0_convt",), "up0.0", transposed=True)
    m.gn(("up0_gn",), "up0.1")
    for i in (1, 2):
        m.conv((f"up{i}_convt",), f"up{i}.model.0", transposed=True)
        m.resconv((f"up{i}_res1",), f"up{i}.model.1")
        m.resconv((f"up{i}_res2",), f"up{i}.model.2")
    m.conv(("out_conv1",), "out.0")
    m.gn(("out_gn",), "out.1")
    m.conv(("out_conv2",), "out.3")


def _walk_cbam_unet(m: _Unmapper) -> None:
    """custom_dataset.py's names (torch_convert.convert_cbam_unet)."""
    m.resconv(("init_conv",), "init_conv")
    for i in range(1, 5):
        m.resconv((f"down{i}", "ResConvBlock_0"), f"down{i}.model.0")
        m.conv((f"down{i}", "Conv_0"), f"down{i}.model.1")
        m.gn((f"down{i}", "GroupNorm_0"), f"down{i}.model.2")
        ca, tk = (f"cbam{i}", "channel_attention"), f"cbam{i}.channel_attention"
        m.conv(ca + ("mlp1",), f"{tk}.shared_MLP.0")
        m.conv(ca + ("mlp2",), f"{tk}.shared_MLP.2")
        m.conv((f"cbam{i}", "spatial_attention", "conv7"),
               f"cbam{i}.spatial_attention.conv2d")
    for name in ("contextembed1", "contextembed2", "timeembed1",
                 "timeembed2"):
        m.embed_fc((name,), name)
    m.conv(("up0_convt",), "up0.0", transposed=True)
    m.gn(("up0_gn",), "up0.1")
    for i in range(1, 5):
        m.conv((f"up{i}", "ConvTranspose_0"), f"up{i}.model.0",
               transposed=True)
        m.resconv((f"up{i}", "ResConvBlock_0"), f"up{i}.model.1")
        m.resconv((f"up{i}", "ResConvBlock_1"), f"up{i}.model.2")
    m.conv(("local_enhance", "Conv_0"), "local_enhance.conv.0")
    m.gn(("local_enhance", "GroupNorm_0"), "local_enhance.conv.1")
    m.conv(("local_enhance", "Conv_1"), "local_enhance.conv.3")
    m.conv(("out_conv1",), "out.0")
    m.gn(("out_gn",), "out.1")
    m.conv(("out_conv2",), "out.3")


_WALKS = {"context_unet_v2": _walk_context_unet,
          "context_unet_v1": _walk_context_unet,
          "mnist_unet": _walk_mnist_unet,
          "cbam_unet": _walk_cbam_unet}


def state_dict_from_flax(params: Dict[str, Any],
                         batch_stats: Optional[Dict[str, Any]] = None,
                         arch: str = "context_unet_v2", **layout
                         ) -> Dict[str, torch.Tensor]:
    """A JAX parameter tree of ``arch`` -> the port's ``state_dict``.
    ``batch_stats`` is required for ``norm="batch"``; ``ddpm_unet`` also
    takes its layout (``ch_mults``, ``is_attn``, ``n_blocks``: a port
    model's ``layout`` holds the arch and these)."""
    if arch == "ddpm_unet":
        return _from_rules(params, ddpm_unet_rules(**layout))
    if arch not in _WALKS:
        raise ValueError(f"no flax mapping for arch {arch!r}")
    m = _Unmapper(params, batch_stats)
    _WALKS[arch](m)
    return {k: torch.from_numpy(np.copy(v, order="C"))
            for k, v in m.sd.items()}


def flax_from_state_dict(sd: Dict[str, torch.Tensor],
                         arch: str = "context_unet_v2", **layout
                         ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The port's ``state_dict`` of ``arch`` -> the JAX package's
    ``(params, batch_stats)`` trees of numpy arrays (float32;
    ``batch_stats`` is empty without BatchNorm): the inverse of
    :func:`state_dict_from_flax`. The arrays are copies.
    ``num_batches_tracked`` has no flax counterpart and is dropped."""
    if arch == "ddpm_unet":
        return _to_rules(sd, ddpm_unet_rules(**layout)), {}
    if arch not in _WALKS:
        raise ValueError(f"no flax mapping for arch {arch!r}")
    # copies: a CPU tensor's .numpy() shares its memory, and the trees
    # must not follow the live parameters (snapshots, checkpoints)
    m = _Mapper({k: v.detach().to("cpu").numpy().copy()
                 for k, v in sd.items()
                 if not k.endswith("num_batches_tracked")})
    _WALKS[arch](m)
    return m.params, m.stats


def load_flax(model: torch.nn.Module, params: Dict[str, Any],
              batch_stats: Optional[Dict[str, Any]] = None) -> None:
    """``model.load_state_dict`` from a JAX parameter tree, through the
    walk or rules of the model's ``layout``."""
    model.load_state_dict(state_dict_from_flax(params, batch_stats,
                                               **model.layout))


def flax_trees(model: torch.nn.Module) -> Tuple[Dict[str, Any],
                                                Dict[str, Any]]:
    """``(params, batch_stats)`` of ``model`` as the JAX package's numpy
    trees."""
    return flax_from_state_dict(model.state_dict(), **model.layout)


def ddpm_unet_rules(ch_mults=(1, 2, 2, 4), is_attn=(False, False, True, True),
                    n_blocks: int = 2):
    """(flax path, state_dict key, kind) for every parameterised layer of
    the labml U-Net behind ``DdpmUNetAdapter``: flax names its layers by
    type and creation order (``ResidualBlock_3``, ``Conv_2`` ...), so the
    counters run through the network as the JAX module builds it. Kinds:
    conv, conv_t, dense, norm. A block that keeps its width has no
    shortcut conv; the rule for it is skipped both ways."""
    top = ("DdpmUNet_0",)
    rules = []
    count = {"ResidualBlock": 0, "AttentionBlock": 0, "Conv": 0,
             "ConvTranspose": 0}

    def name(kind):
        n = f"{kind}_{count[kind]}"
        count[kind] += 1
        return top + (n,)

    def res(tk):
        fp = name("ResidualBlock")
        rules.extend([
            (fp + ("GroupNorm_0",), f"{tk}.norm1", "norm"),
            (fp + ("Conv_0",), f"{tk}.conv1", "conv"),
            (fp + ("Dense_0",), f"{tk}.time_emb", "dense"),
            (fp + ("GroupNorm_1",), f"{tk}.norm2", "norm"),
            (fp + ("Conv_1",), f"{tk}.conv2", "conv"),
            (fp + ("Conv_2",), f"{tk}.shortcut", "conv")])

    def attn(tk):
        fp = name("AttentionBlock")
        rules.extend([(fp + ("Dense_0",), f"{tk}.projection", "dense"),
                      (fp + ("Dense_1",), f"{tk}.output", "dense")])

    rules.append((top + ("TimeEmbedding_0", "Dense_0"), "time_emb.lin1",
                  "dense"))
    rules.append((top + ("TimeEmbedding_0", "Dense_1"), "time_emb.lin2",
                  "dense"))
    rules.append((name("Conv"), "image_proj", "conv"))
    k = 0
    for i in range(len(ch_mults)):
        for _ in range(n_blocks):
            res(f"down.{k}.res")
            if is_attn[i]:
                attn(f"down.{k}.attn")
            k += 1
        if i < len(ch_mults) - 1:
            rules.append((name("Conv"), f"down.{k}.conv", "conv"))
            k += 1
    res("middle.res1")
    attn("middle.attn")
    res("middle.res2")
    k = 0
    for i in reversed(range(len(ch_mults))):
        for _ in range(n_blocks):
            res(f"up.{k}.res")
            if is_attn[i]:
                attn(f"up.{k}.attn")
            k += 1
        res(f"up.{k}.res")
        k += 1
        if i > 0:
            rules.append((name("ConvTranspose"), f"up.{k}.conv", "conv_t"))
            k += 1
    rules.append((top + ("GroupNorm_0",), "norm", "norm"))
    rules.append((name("Conv"), "final", "conv"))
    return rules


# --- latent diffusion: flax trees <-> SD-v1 names --------------------------
#
# The port's LDM modules carry the SD-v1 checkpoint's names, so these are
# the inverse of ``diffusionmodel_tpu/compat/sd_convert.py``
# (``convert_sd_unet`` / ``convert_sd_autoencoder``): the same
# (flax path, SD key, kind) rules, kept here as the port's own copy. One
# table serves both directions: ``_from_rules`` reads flax trees into a
# ``state_dict`` (JAX ``train_ldm`` pickles), ``_to_rules`` writes a
# ``state_dict`` out as flax trees (the port's ``train_ldm`` pickles).

def ldm_unet_rules(channel_multipliers=(1, 2, 4, 4),
                   attention_levels=(0, 1, 2), n_res_blocks: int = 2,
                   tf_layers: int = 1):
    """(flax path, SD key, kind) for every parameterised layer of the LDM
    UNet; kind is conv, dense, dense_nobias or norm (``_from_rules`` and
    ``_to_rules`` also take conv_t, a transposed conv)."""
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
        sd[f"{tkey}.weight"] = {"conv": _conv, "conv_t": _conv_t}.get(
            kind, _lin)(k)
        if kind != "dense_nobias" and "bias" in node:
            sd[f"{tkey}.bias"] = np.asarray(node["bias"])
    return {k: torch.from_numpy(np.array(v, np.float32, order="C"))
            for k, v in sd.items()}


def _conv_inv(w):
    return np.transpose(w, (2, 3, 1, 0))


def _to_rules(sd: Dict[str, torch.Tensor], rules) -> Dict[str, Any]:
    """Apply (flax path, key, kind) rules to a ``state_dict``: the flax
    tree of float32 numpy arrays that ``_from_rules`` reads back. A rule
    whose key the dict lacks (a skip conv of a block that keeps its width)
    is left out, as the flax module has no such layer."""
    tree: Dict[str, Any] = {}

    def arr(key):
        return np.ascontiguousarray(
            sd[key].detach().to("cpu", torch.float32).numpy())

    for fpath, tkey, kind in rules:
        if f"{tkey}.weight" not in sd:
            continue
        node = tree
        for p in fpath:
            node = node.setdefault(p, {})
        w = arr(f"{tkey}.weight")
        if kind == "norm":
            node["scale"], node["bias"] = w, arr(f"{tkey}.bias")
            continue
        if kind == "conv_t":  # inverse of _conv_t (transpose and flip)
            k = np.transpose(w, (2, 3, 0, 1))[::-1, ::-1]
        else:
            k = _conv_inv(w) if kind == "conv" else _lin(w)
        node["kernel"] = np.ascontiguousarray(k)
        if kind != "dense_nobias" and f"{tkey}.bias" in sd:
            node["bias"] = arr(f"{tkey}.bias")
    return tree


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


def ldm_unet_flax_from_state_dict(sd: Dict[str, torch.Tensor],
                                  channel_multipliers=(1, 2, 4, 4),
                                  attention_levels=(0, 1, 2),
                                  n_res_blocks: int = 2, tf_layers: int = 1
                                  ) -> Dict[str, Any]:
    """The port's ``UNetModel`` state_dict -> the JAX ``UNetModel``
    parameter tree (numpy leaves), the inverse of
    :func:`ldm_unet_state_dict_from_flax`."""
    return _to_rules(sd, ldm_unet_rules(
        channel_multipliers, attention_levels, n_res_blocks, tf_layers))


def autoencoder_flax_from_state_dict(sd: Dict[str, torch.Tensor],
                                     ch_mults=(1, 2, 4, 4),
                                     n_resnet: int = 2) -> Dict[str, Any]:
    """The port's ``Autoencoder`` state_dict -> the JAX ``Autoencoder``
    parameter tree (numpy leaves), the inverse of
    :func:`autoencoder_state_dict_from_flax`."""
    return _to_rules(sd, autoencoder_rules(ch_mults, n_resnet))


def inception_state_dict_from_flax(params: Dict[str, Any],
                                   batch_stats: Dict[str, Any]
                                   ) -> Dict[str, torch.Tensor]:
    """A JAX ``InceptionV3Features`` tree (``params``, ``batch_stats``) ->
    the port's ``metrics.inception.InceptionV3Features`` state_dict
    (torchvision's names): the inverse of the JAX package's
    ``convert_torchvision_inception``. Every ``BasicConv2d`` is a
    ``.../conv`` kernel and a ``.../bn`` scale, bias, mean and var."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(node, stats, path):
        if "conv" in node and "bn" in node:
            key = ".".join(path)
            bn, st = node["bn"], stats["bn"]
            for name, v in (("conv.weight", _conv(node["conv"]["kernel"])),
                            ("bn.weight", bn["scale"]),
                            ("bn.bias", bn["bias"]),
                            ("bn.running_mean", st["mean"]),
                            ("bn.running_var", st["var"])):
                sd[f"{key}.{name}"] = torch.from_numpy(
                    np.array(v, np.float32, order="C"))
            sd[f"{key}.bn.num_batches_tracked"] = torch.tensor(0)
            return
        for k in node:
            walk(node[k], stats[k], path + (k,))

    walk(params, batch_stats, ())
    return sd
