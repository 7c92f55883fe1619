"""Reading the JAX package's checkpoints (counterpart of the loading half of
``diffusionmodel_tpu/checkpoint.py``).

A JAX checkpoint is a pickle (``*.pkl``) or a directory holding one
(``ckpt_ep*/payload.pkl``, ``best_model/payload.pkl``) of
``{params, batch_stats, opt_state, ema_params, epoch, ...}`` with numpy
leaves. ``opt_state`` may pickle optimizer classes (optax named tuples), so
the loader's unpickler resolves only numpy, a few builtin containers and
the standard library's pickle helpers; every other class becomes an inert
stand-in, and jax, flax and optax are never imported. Load only files this
project wrote: unpickling runs constructors.

Turn the parameters into the port's weights with
``compat.flax_bridge.state_dict_from_flax``.
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import Any, Dict

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
        if module == "builtins" and name in _SAFE_BUILTINS:
            return super().find_class(module, name)
        return type(name, (_Stub,), {"_qualname": f"{module}.{name}"})


def _unpickle(path: str) -> Any:
    with open(path, "rb") as f:
        return _Unpickler(f).load()


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A ``.pkl`` file or a checkpoint directory with ``payload.pkl``.
    Like the JAX loader, a directory lost between the two renames of an
    interrupted save is recovered from its ``<path>.old-<pid>`` copy."""
    if path.endswith(".pkl"):
        return _unpickle(path)
    if not os.path.isdir(path):
        stranded = sorted(glob.glob(f"{path}.old-*"), key=os.path.getmtime)
        if stranded:
            path = stranded[-1]
    payload = os.path.join(path, _PICKLE_NAME)
    if os.path.isdir(path) and os.path.exists(payload):
        return _unpickle(payload)
    raise ValueError(
        f"{path!r} is neither a .pkl checkpoint nor a directory holding "
        f"{_PICKLE_NAME}; orbax and torch .pt checkpoints are not read by "
        "the port yet (ROADMAP A7)")


def extract_params(ckpt: Dict[str, Any], prefer_ema: bool = True) -> Any:
    """The parameter tree of a checkpoint: ``ema_params`` when present and
    ``prefer_ema`` (EMA exists to be sampled from), else ``params``; a bare
    tree is returned as it is."""
    if isinstance(ckpt, dict):
        if prefer_ema and ckpt.get("ema_params") is not None:
            return ckpt["ema_params"]
        if "params" in ckpt:
            return ckpt["params"]
    return ckpt
