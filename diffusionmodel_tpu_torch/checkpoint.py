"""Checkpoints in the JAX package's format (counterpart of
``diffusionmodel_tpu/checkpoint.py``): writing them, and reading both
packages' files.

A JAX checkpoint is a pickle (``*.pkl``) or a directory holding one
(``ckpt_ep*/payload.pkl``, ``best_model/payload.pkl``) of
``{params, batch_stats, opt_state, ema_params, epoch, ...}`` with numpy
leaves. ``opt_state`` may pickle optimizer classes (optax named tuples), so
the loader's unpickler resolves only numpy, a few builtin containers and
the standard library's pickle helpers; every other class becomes an inert
stand-in, and jax, flax and optax are never imported. bfloat16 arrays (the
JAX package's Adam first moment, an ``ml_dtypes`` type) load as uint16
arrays of their raw bits. Load only files this
project wrote: unpickling runs constructors.

Turn the parameters into the port's weights with
``compat.flax_bridge.state_dict_from_flax``; ``flax_from_state_dict`` goes
the other way, and ``save_checkpoint`` writes the payload, so the JAX
package's ``load_checkpoint`` reads what the port writes.

A PyTorch ``.pt`` / ``.pth`` file (the reference's layouts: a training
dict with ``model_state_dict``, or a bare state dict, keys possibly under
``nn_model.`` beside the DDPM wrapper's schedule buffers) is read with
``torch.load(weights_only=True)``, or ``weights_only=False`` for a pickle
that needs it; its state dict is the port's own naming for the arches the
JAX package converts (context_unet_v2 / v1, cbam_unet, mnist_unet) and is
returned as flax trees, like every other checkpoint.
"""

from __future__ import annotations

import glob
import os
import pickle
import shutil
from typing import Any, Dict, Optional

import numpy as np

_PICKLE_NAME = "payload.pkl"

_SAFE_BUILTINS = {
    "dict", "list", "tuple", "set", "frozenset", "int", "float", "complex",
    "bool", "str", "bytes", "bytearray", "slice", "range", "object",
}


class _Stub:
    """Stand-in for a class outside numpy/builtins found in a pickle."""

    _qualname = "?"

    def __new__(cls, *args, **kwargs):
        obj = object.__new__(cls)
        obj.args = args
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.state = state

    def __repr__(self):
        return f"<stub {self._qualname}>"


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        root = module.split(".")[0]
        if root == "numpy" or module in ("collections", "copyreg", "_codecs"):
            return super().find_class(module, name)
        if root == "ml_dtypes" and name == "bfloat16":
            return np.uint16  # bfloat16 arrays load as their raw bits
        if module == "builtins" and name in _SAFE_BUILTINS:
            return super().find_class(module, name)
        return type(name, (_Stub,), {"_qualname": f"{module}.{name}"})


def _unpickle(path: str) -> Any:
    with open(path, "rb") as f:
        return _Unpickler(f).load()


def _check_host(obj, where: str = "payload") -> None:
    """A payload holds numpy arrays and builtins only: it must load where
    neither torch nor the port is importable (the JAX package)."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            _check_host(v, f"{where}[{k!r}]")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _check_host(v, f"{where}[{i}]")
    elif not isinstance(obj, (np.ndarray, np.generic, int, float, str,
                              bool, bytes, type(None))):
        raise TypeError(f"{where} is a {type(obj).__name__}; a checkpoint "
                        "payload holds numpy arrays and builtins only")


def save_checkpoint(path: str, payload: Dict[str, Any],
                    fmt: str = "pickle") -> str:
    """Write ``payload`` (numpy and builtins only) as the JAX package does.

    A path ending in ``.pkl`` is written to a temp file and moved into
    place with ``os.replace``. Any other path is a checkpoint directory
    holding ``payload.pkl``: written to a temp dir, then swapped in by
    renaming the old directory aside first (so at every instant either the
    old or the new checkpoint is reachable, and ``load_checkpoint``
    recovers a stranded ``.old-*``), and leftovers of killed writers of
    this name are removed. Orbax directories are not written by the port
    (it cannot import orbax)."""
    if fmt != "pickle":
        raise NotImplementedError(
            f"checkpoint format {fmt!r} is not written by the port (it "
            "cannot import orbax); use the default pickle layout")
    _check_host(payload)
    if path.endswith(".pkl"):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
        return path
    path = os.path.abspath(path)
    tmp_dir = f"{path}.tmp-{os.getpid()}"
    os.makedirs(tmp_dir, exist_ok=True)
    with open(os.path.join(tmp_dir, _PICKLE_NAME), "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    if os.path.isdir(path):
        old_dir = f"{path}.old-{os.getpid()}"
        os.rename(path, old_dir)
        os.rename(tmp_dir, path)
        shutil.rmtree(old_dir, ignore_errors=True)
    else:
        os.rename(tmp_dir, path)
    for stale in glob.glob(f"{path}.tmp-*") + glob.glob(f"{path}.old-*"):
        shutil.rmtree(stale, ignore_errors=True)
    return path


_SCHEDULE_BUFFERS = {"alpha_t", "oneover_sqrta", "sqrt_beta_t", "alphabar_t",
                     "sqrtab", "sqrtmab", "mab_over_sqrtmab"}
# scripy_old.py's v1 names -> the port's ContextUnet names (v2's)
_V1_NAMES = (("channel_compressor", "channel_compress"),
             ("channel_adjust", "ch_adjust"), ("timeembed", "time_emb"),
             ("contextembed", "ctx_emb"))
TORCH_ARCHS = ("context_unet_v2", "context_unet_v1", "cbam_unet",
               "mnist_unet")


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """A ``.pt`` / ``.pth`` file -> ``{"model_state_dict": {name: tensor},
    **extras, "weights_only": bool}``: the training dict's
    ``model_state_dict`` or the bare state dict, with the extras that are
    not tensors (epoch, loss, ...), as the JAX package's
    ``torch_convert.load_torch_checkpoint``. ``torch.load`` runs with
    ``weights_only=True`` first and falls back to ``weights_only=False``
    (which runs the pickle's code: load only files you trust) when the
    file needs it; ``weights_only`` says which was used."""
    import torch

    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        weights_only = True
    except pickle.UnpicklingError:
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        weights_only = False
    if isinstance(ckpt, dict) and "model_state_dict" in ckpt:
        sd = ckpt["model_state_dict"]
        extras = {k: v for k, v in ckpt.items() if k != "model_state_dict"
                  and not hasattr(v, "numpy")}
    else:
        sd, extras = ckpt, {}
    sd = {k: v.detach().cpu() for k, v in sd.items() if hasattr(v, "detach")}
    return {"model_state_dict": sd, **extras, "weights_only": weights_only}


def _strip_prefix(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Drop the DDPM wrapper's ``nn_model.`` prefix and schedule buffers."""
    return {k[len("nn_model."):] if k.startswith("nn_model.") else k: v
            for k, v in sd.items() if k not in _SCHEDULE_BUFFERS}


def torch_state_dict(sd: Dict[str, Any], arch: str) -> Dict[str, Any]:
    """A reference state dict in the port's names for ``arch`` (prefix and
    buffers dropped; v1's attribute names renamed to v2's). Raises for an
    arch the JAX package has no converter for (``ddpm_unet``)."""
    if arch not in TORCH_ARCHS:
        raise ValueError(f"no converter for arch {arch!r}")
    sd = _strip_prefix(sd)
    if arch == "context_unet_v1":
        def rename(k):
            for old, new in _V1_NAMES:
                k = k.replace(old, new)
            return k

        sd = {rename(k): v for k, v in sd.items()}
    return sd


def load_checkpoint(path: str, arch: Optional[str] = None,
                    norm: str = "batch") -> Dict[str, Any]:
    """A ``.pkl`` file, a checkpoint directory with ``payload.pkl``, or a
    PyTorch ``.pt`` / ``.pth`` file. Like the JAX loader, a directory lost
    between the two renames of an interrupted save is recovered from its
    ``<path>.old-<pid>`` copy.

    A ``.pt`` file needs ``arch`` (the ModelConfig's): its state dict goes
    through ``torch_state_dict`` and the arch's flax walk into ``params``
    / ``batch_stats`` (so ``load_state_dict`` of the port's model takes it
    as it is); without ``arch`` the state dict is returned under
    ``torch_state_dict`` and ``extract_params`` refuses it, as in the JAX
    package. ``norm`` is accepted for the JAX signature: the walk reads
    BatchNorm from the running statistics the file holds. Orbax
    directories are refused: the port cannot import orbax."""
    if path.endswith(".pkl"):
        return _unpickle(path)
    if path.endswith((".pt", ".pth")):
        from diffusionmodel_tpu_torch.compat.flax_bridge import (
            flax_from_state_dict,
        )

        raw = load_torch_checkpoint(path)
        sd = raw.pop("model_state_dict")
        if arch is None:
            return {"torch_state_dict": sd, **raw}
        params, batch_stats = flax_from_state_dict(
            torch_state_dict(sd, arch), arch=arch)
        return {"params": params, "batch_stats": batch_stats, **raw}
    if not os.path.isdir(path):
        stranded = sorted(glob.glob(f"{path}.old-*"), key=os.path.getmtime)
        if stranded:
            path = stranded[-1]
    payload = os.path.join(path, _PICKLE_NAME)
    if os.path.isdir(path) and os.path.exists(payload):
        return _unpickle(payload)
    if os.path.isdir(path):
        raise ValueError(
            f"{path!r} holds no {_PICKLE_NAME}: orbax checkpoint "
            "directories are not read by the port (it cannot import "
            "orbax); re-save it with the JAX package's default pickle "
            "layout")
    raise ValueError(
        f"{path!r} is neither a .pkl checkpoint, a directory holding "
        f"{_PICKLE_NAME} nor a .pt/.pth file")


def extract_params(ckpt: Dict[str, Any], prefer_ema: bool = True) -> Any:
    """The parameter tree of a checkpoint: ``ema_params`` when present and
    ``prefer_ema`` (EMA exists to be sampled from), else ``params``; a bare
    tree is returned as it is. A ``.pt`` file read without an arch is
    refused."""
    if isinstance(ckpt, dict):
        if "torch_state_dict" in ckpt:
            raise ValueError(
                "torch .pt checkpoint was loaded without an arch — pass "
                "arch/norm (from the ModelConfig) to load_checkpoint so the "
                "state dict is converted to flax params")
        if prefer_ema and ckpt.get("ema_params") is not None:
            return ckpt["ema_params"]
        if "params" in ckpt:
            return ckpt["params"]
    return ckpt
