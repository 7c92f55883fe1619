"""The port's ``.pt`` / ``.pth`` reader (``checkpoint.load_checkpoint(path,
arch, norm)``) against the JAX package's (``compat/torch_convert``), CPU.

For each arch the JAX package converts (ContextUnet v2 and v1 at n_feat
16 and 32 px as in ``tests/test_kernels.py``, the CBAM and the MNIST
UNets at n_feat 8 and 16 px), a port model's ``state_dict`` is saved with
``torch.save`` in the reference's layouts: the training dict
``{"model_state_dict": {"nn_model." + k: v} + the DDPM wrapper's schedule
buffers, "epoch", ...}`` and the bare state dict (v1 in scripy_old.py's
own attribute names). Both loaders read each file: the parameter trees
are equal bit for bit, the port's reloaded model gives the saved model's
output bit for bit, and the JAX forward on its tree matches (rtol 5e-3 /
atol 1e-4, PARITY.md's full-model tolerance). ``ddpm_unet`` is refused
as the JAX package refuses it.
"""

import os
import pickle

import numpy as np
import pytest
import torch

import jax

from diffusionmodel_tpu import checkpoint as jckpt
from diffusionmodel_tpu.config import preset as jpreset
from diffusionmodel_tpu.nn import build_model as jbuild_model
from diffusionmodel_tpu_torch import checkpoint as tckpt
from diffusionmodel_tpu_torch.compat.flax_bridge import load_flax
from diffusionmodel_tpu_torch.config import preset
from diffusionmodel_tpu_torch.nn import build_model

torch.set_num_threads(2)

RTOL, ATOL = 5e-3, 1e-4
BUFFERS = ("alpha_t", "oneover_sqrta", "sqrt_beta_t", "alphabar_t", "sqrtab",
           "sqrtmab", "mab_over_sqrtmab")
# arch -> (preset, overrides, norm)
ARCHS = {
    "context_unet_v2": ("full", {"model.n_feat": 16, "model.img_size": 32,
                                 "model.norm": "batch"}, "batch"),
    "context_unet_v1": ("old", {"model.n_feat": 16, "model.img_size": 32},
                        "group"),
    "cbam_unet": ("custom", {"model.n_feat": 8, "model.img_size": 16},
                  "group"),
    "mnist_unet": ("mnist", {"model.n_feat": 8, "model.img_size": 16},
                   "batch"),
}
V1_NAMES = (("channel_compress", "channel_compressor"),
            ("ch_adjust", "channel_adjust"), ("time_emb", "timeembed"),
            ("ctx_emb", "contextembed"))


def _model(arch, seed=0):
    name, over, _ = ARCHS[arch]
    cfg = preset(name, **over)
    torch.manual_seed(seed)
    model = build_model(cfg.model, cfg.diffusion.high_thresh, device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for n, b in model.named_buffers():
            if n.endswith("running_mean"):
                b.copy_(0.1 * torch.randn(b.shape, generator=g))
            elif n.endswith("running_var"):
                b.copy_(0.5 + torch.rand(b.shape, generator=g))
    return cfg, model


def _reference_names(sd, arch):
    if arch != "context_unet_v1":
        return dict(sd)
    out = {}
    for k, v in sd.items():
        for new, old in V1_NAMES:
            k = k.replace(new, old)
        out[k] = v
    return out


def _save(path, model, arch, layout):
    sd = _reference_names(model.state_dict(), arch)
    if layout == "training_dict":
        wrapped = {"nn_model." + k: v for k, v in sd.items()}
        wrapped.update({b: torch.rand(11) for b in BUFFERS})
        torch.save({"model_state_dict": wrapped, "epoch": 3, "loss": 0.5,
                    "metrics": {"fid": 1.0}}, path)
    else:
        torch.save(sd, path)
    return str(path)


def _inputs(cfg, seed=2):
    mc = cfg.model
    rng = np.random.RandomState(seed)
    s = mc.img_size
    return (rng.randn(2, s, s, mc.in_ch).astype(np.float32),
            (np.arange(2) % mc.n_classes).astype(np.int32),
            rng.rand(2).astype(np.float32), np.array([1.0, 0.0], np.float32),
            rng.choice([0.5, 3.0], (2, s, s)).astype(np.float32))


def _forward(model, args):
    with torch.no_grad():
        return model.eval()(*(torch.from_numpy(a) for a in args)).numpy()


@pytest.mark.parametrize("layout", ["training_dict", "bare"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_pt_checkpoint_read_by_both_loaders(tmp_path, arch, layout):
    cfg, model = _model(arch)
    norm = ARCHS[arch][2]
    path = _save(tmp_path / "model.pt", model, arch, layout)
    ours = tckpt.load_checkpoint(path, arch=arch, norm=norm)
    theirs = jckpt.load_checkpoint(path, arch=arch, norm=norm)
    assert ours["weights_only"] is True
    if layout == "training_dict":
        assert ours["epoch"] == theirs["epoch"] == 3
    for key in ("params", "batch_stats"):
        a, b = ours[key], theirs[key]
        assert jax.tree.structure(a) == jax.tree.structure(b)
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            np.testing.assert_array_equal(x, y)

    args = _inputs(cfg)
    torch.manual_seed(5)
    fresh = build_model(cfg.model, cfg.diffusion.high_thresh, device="cpu")
    load_flax(fresh, tckpt.extract_params(ours), ours["batch_stats"])
    got = _forward(fresh, args)
    np.testing.assert_array_equal(got, _forward(model, args))
    jcfg = jpreset(ARCHS[arch][0], **ARCHS[arch][1])
    jm = jbuild_model(jcfg.model, jcfg.diffusion.high_thresh)
    variables = {"params": jckpt.extract_params(theirs)}
    if theirs["batch_stats"]:
        variables["batch_stats"] = theirs["batch_stats"]
    x, c, t, ctx, attn = args
    want = jax.jit(lambda v: jm.apply(v, x, c, t, ctx, attn_mask=attn,
                                      train=False))(variables)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_pt_refusals_match_jax(tmp_path):
    """No arch: the raw state dict, which ``extract_params`` refuses;
    ``ddpm_unet`` (no converter in the JAX package) refused by both; a
    ``.pth`` whose pickle holds a class ``weights_only`` cannot load is
    read with ``weights_only=False`` and says so; an orbax directory is
    refused with a message that says why."""
    _, model = _model("mnist_unet")
    path = _save(tmp_path / "m.pth", model, "mnist_unet", "bare")
    for mod in (tckpt, jckpt):
        raw = mod.load_checkpoint(path)
        assert "torch_state_dict" in raw
        with pytest.raises(ValueError, match="without an arch"):
            mod.extract_params(raw)
        with pytest.raises(ValueError, match="no converter for arch"):
            mod.load_checkpoint(path, arch="ddpm_unet")
    odd = str(tmp_path / "odd.pt")
    torch.save({"model_state_dict": model.state_dict(),
                "config": pickle.PickleError("a class")}, odd)
    ck = tckpt.load_checkpoint(odd, arch="mnist_unet", norm="batch")
    assert ck["weights_only"] is False and "config" in ck
    orbax = tmp_path / "orbax_dir"
    os.makedirs(orbax / "something")
    with pytest.raises(ValueError, match="orbax"):
        tckpt.load_checkpoint(str(orbax))
