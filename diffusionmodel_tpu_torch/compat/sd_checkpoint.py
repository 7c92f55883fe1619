"""Loading a Stable-Diffusion v1 checkpoint into the port's LDM modules
(counterpart of ``diffusionmodel_tpu/compat/sd_convert.load_sd_checkpoint``).

The port's ``UNetModel`` and ``Autoencoder`` carry the SD-v1 names, so a
``sd-v1-*.ckpt`` loads by stripping ``model.diffusion_model.`` and
``first_stage_model.`` and calling ``load_state_dict`` non-strict: keys the
checkpoint lacks keep their initial values, and keys the modules do not
have (the CLIP text encoder, EMA copies, schedule buffers) are reported and
left alone, as in the JAX loader. Shapes must match. The file is unpickled
with ``weights_only=False`` (SD checkpoints pickle training state); load
only checkpoints you trust.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn

UNET_PREFIX = "model.diffusion_model."
AE_PREFIX = "first_stage_model."


def load_sd_checkpoint(path: str, unet: nn.Module, autoencoder: nn.Module
                       ) -> Tuple[List[str], List[str]]:
    """Load ``path`` (a dict with ``state_dict``, or a bare state dict)
    into ``unet`` and ``autoencoder`` in place, cast to fp32. Returns
    ``(missing, extra)``: the prefixed module keys the checkpoint lacks, and
    the checkpoint's tensor keys that neither module reads."""
    raw = torch.load(path, map_location="cpu", weights_only=False)
    sd = raw.get("state_dict", raw)
    sd = {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}
    missing: List[str] = []
    expected = set()
    for prefix, module in ((UNET_PREFIX, unet), (AE_PREFIX, autoencoder)):
        own = module.state_dict()
        sub = {k[len(prefix):]: v.to(torch.float32) for k, v in sd.items()
               if k.startswith(prefix) and k[len(prefix):] in own}
        missing += [prefix + k for k in own if k not in sub]
        expected |= {prefix + k for k in own}
        module.load_state_dict(sub, strict=False)
    return missing, sorted(set(sd) - expected)
