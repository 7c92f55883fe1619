"""User-facing LDM runner (counterpart of
``diffusionmodel_tpu/models/latent_diffusion/runner.py``): builds the
stable-diffusion stack once and exposes txt2img / img2img / inpaint, as
``--mode txt2img|img2img|inpaint`` of the CLI does.

- Conditioning: the CLIP text encoder (``CLIPTextEmbedder``) when one is
  given, or for the SD-sized ``d_cond`` (768) when transformers and local
  CLIP weights load; otherwise, as in the JAX package, its documented
  fallback, a prompt-hashed Gaussian embedding of shape [B, 77, d_cond]
  (bit-identical to the JAX package's).
- Weights: a real SD-v1 checkpoint through ``compat.sd_checkpoint`` when
  given (non-strict), or a ``--mode train_ldm`` pickle of either package
  (``{arch, unet, ae}`` flax trees) through ``compat.flax_bridge``; else
  PyTorch's default initialisation drawn from a torch seed. Random weights
  differ from the JAX runner's (another generator and another init rule).
- The JAX runner's per-shape ``jit`` cache and its chunked device fetch
  are workarounds for the TPU's compile service and host link; PyTorch
  runs eagerly and needs neither.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Union

import numpy as np
import torch

from diffusionmodel_tpu_torch.checkpoint import _unpickle
from diffusionmodel_tpu_torch.compat.flax_bridge import (
    autoencoder_state_dict_from_flax,
    ldm_unet_state_dict_from_flax,
)
from diffusionmodel_tpu_torch.device_check import fp32_compute, resolve_device
from diffusionmodel_tpu_torch.models.latent_diffusion.autoencoder import (
    Autoencoder,
)
from diffusionmodel_tpu_torch.models.latent_diffusion.latent_diffusion import (
    CLIPTextEmbedder,
    LatentDiffusion,
)
from diffusionmodel_tpu_torch.models.latent_diffusion.pipelines import (
    Img2Img,
    InPaint,
    Txt2Img,
)
from diffusionmodel_tpu_torch.models.latent_diffusion.unet import UNetModel

# The JAX package's architectures: "sd" is SD-v1 (860M UNet), "tiny" a
# CPU-testable miniature of the same topology, "mid" ~1/10 of "sd".
ARCHS = {
    "sd": dict(channels=320, channel_multipliers=(1, 2, 4, 4),
               attention_levels=(0, 1, 2), n_heads=8, d_cond=768,
               ae_channels=128, ae_mults=(1, 2, 4, 4)),
    "tiny": dict(channels=32, channel_multipliers=(1, 2), n_res_blocks=1,
                 attention_levels=(0,), n_heads=2, d_cond=64,
                 ae_channels=32, ae_mults=(1, 1, 2, 2)),
    "mid": dict(channels=128, channel_multipliers=(1, 2, 4),
                n_res_blocks=2, attention_levels=(0, 1), n_heads=4,
                d_cond=256, ae_channels=64, ae_mults=(1, 2, 4, 4)),
}


def _hash_embedding(prompts, d_cond: int, max_length: int = 77) -> np.ndarray:
    """Deterministic prompt -> [B, 77, d_cond] Gaussian embedding (the
    no-CLIP fallback; the same prompt gives the same conditioning)."""
    out = []
    for p in prompts:
        seed = int.from_bytes(
            hashlib.sha256(p.encode("utf-8")).digest()[:4], "little")
        out.append(np.random.RandomState(seed)
                   .randn(max_length, d_cond).astype(np.float32))
    return np.stack(out)


def _clip_or_none(device: torch.device, log):
    """CLIP-L from the local cache on ``device``, or None when it does not
    load (no transformers, no weights): the runner then conditions through
    the prompt hash."""
    try:
        return CLIPTextEmbedder(local_files_only=True, device=device)
    except Exception as e:
        log(f"CLIP unavailable ({type(e).__name__}); falling back to "
            "deterministic prompt-hash conditioning")
        return None


class LdmRunner:
    """The LDM stack on one device (default CUDA; raises without it unless
    ``device="cpu"``). ``sampler_name`` and ``steps`` may be changed
    between calls. txt2img / img2img / inpaint run fp32 with TF32 off
    (``device_check.fp32_compute``) for the call, with cuDNN's heuristics:
    autotuning saves 0.6 s of a 6.6 s txt2img DDIM-50 at 512 px but its
    search costs the first call 23 s, and each CLI call is a process of
    its own (NVIDIA H100; tools/fp32_autotune_probe.py).

    ``embedder`` (prompts -> [B, 77, d_cond]) conditions every call when
    given; else, with ``use_clip`` and d_cond 768 (CLIP-L's width, so the
    ``sd`` arch only), CLIP-L is loaded from the local cache, and the
    prompt hash serves when it does not load."""

    def __init__(self, sd_ckpt: Optional[str] = None, arch: str = "sd",
                 use_flash: bool = True, sampler: str = "ddim",
                 steps: int = 50, ddim_eta: float = 0.0, seed: int = 42,
                 verbose: bool = True, native_ckpt: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 use_clip: bool = True, embedder=None):
        self.device = resolve_device(device)
        payload = _unpickle(native_ckpt) if native_ckpt else None
        if payload is not None and payload.get("arch") not in (None, arch):
            raise ValueError(
                f"native checkpoint was trained with arch="
                f"{payload['arch']!r}; runner built with {arch!r}")
        a = dict(ARCHS[arch])
        ae_channels, ae_mults = a.pop("ae_channels"), a.pop("ae_mults")
        self.arch, self.d_cond = arch, a["d_cond"]
        self.sampler_name, self.steps, self.ddim_eta = sampler, steps, ddim_eta
        self.verbose = verbose
        devices = [self.device] if self.device.type == "cuda" else []
        with torch.random.fork_rng(devices=devices), torch.device(self.device):
            torch.manual_seed(seed)
            self.unet = UNetModel(use_flash=use_flash, **a)
            self.ae = Autoencoder(channels=ae_channels, ch_mults=ae_mults)
        if sd_ckpt:
            from diffusionmodel_tpu_torch.compat.sd_checkpoint import (
                load_sd_checkpoint,
            )

            missing, extra = load_sd_checkpoint(sd_ckpt, self.unet, self.ae)
            msg = f"Loaded SD checkpoint: {sd_ckpt}"
            if missing:
                msg += (f" ({len(missing)} keys missing, kept at init; "
                        "non-strict like the reference loader)")
            if extra:
                msg += f" ({len(extra)} checkpoint keys unused)"
            self._log(msg)
        else:
            self._log("No SD checkpoint given: using random weights from "
                      f"torch seed {seed}")
        if payload is not None:
            self.unet.load_state_dict(ldm_unet_state_dict_from_flax(
                payload["unet"], a["channel_multipliers"],
                a["attention_levels"], a.get("n_res_blocks", 2)))
            if "ae" in payload:
                self.ae.load_state_dict(autoencoder_state_dict_from_flax(
                    payload["ae"], ae_mults))
            self._log(f"Loaded native LDM checkpoint: {native_ckpt}")
        self.unet.to(memory_format=torch.channels_last).eval()
        self.ae.to(memory_format=torch.channels_last).eval()
        self.model = LatentDiffusion(self.unet, self.ae.encode,
                                     self.ae.decode, device=self.device)
        self.embedder = embedder
        if embedder is None and use_clip and self.d_cond == 768:
            self.embedder = _clip_or_none(self.device, self._log)

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(msg)

    def cond(self, prompts) -> torch.Tensor:
        if self.embedder is not None:
            return self.embedder(list(prompts)).to(self.device,
                                                   torch.float32)
        return torch.from_numpy(_hash_embedding(list(prompts), self.d_cond)
                                ).to(self.device)

    def _generator(self, generator):
        if generator is not None:
            return generator
        return torch.Generator(device=self.device).manual_seed(0)

    @staticmethod
    def _out(x: torch.Tensor) -> np.ndarray:
        return x.float().cpu().numpy()

    def txt2img(self, prompt: str, batch_size: int = 1, h: int = 512,
                w: int = 512, uncond_scale: float = 7.5,
                generator: Optional[torch.Generator] = None,
                skip_steps: int = 0) -> np.ndarray:
        """prompt -> [B, h, w, 3] images in about [-1, 1]. ``skip_steps``
        (DDIM, DDPM) runs only the last steps of the schedule."""
        pipe = Txt2Img(self.model, sampler=self.sampler_name,
                       n_steps=self.steps, ddim_eta=self.ddim_eta)
        with fp32_compute(self.device, autotune=False):
            return self._out(pipe(
                self.cond([prompt] * batch_size), batch_size=batch_size,
                h=h, w=w, uncond_scale=uncond_scale,
                uncond=self.cond([""] * batch_size),
                generator=self._generator(generator),
                skip_steps=skip_steps))

    def img2img(self, orig_img: np.ndarray, prompt: str,
                strength: float = 0.75, uncond_scale: float = 5.0,
                generator: Optional[torch.Generator] = None) -> np.ndarray:
        """[B,H,W,3] image in [-1, 1] + prompt -> repainted images."""
        batch = int(orig_img.shape[0])
        pipe = Img2Img(self.model, n_steps=self.steps, ddim_eta=self.ddim_eta)
        with fp32_compute(self.device, autotune=False):
            return self._out(pipe(
                orig_img, self.cond([prompt] * batch), strength=strength,
                uncond_scale=uncond_scale, uncond=self.cond([""] * batch),
                generator=self._generator(generator)))

    def inpaint(self, orig_img: np.ndarray, prompt: str,
                mask: Optional[np.ndarray] = None, strength: float = 0.75,
                uncond_scale: float = 5.0,
                generator: Optional[torch.Generator] = None) -> np.ndarray:
        """Masked repaint; ``mask`` is a [B,h/8,w/8,4] latent keep-mask
        (1 = keep the original), by default the bottom half."""
        batch = int(orig_img.shape[0])
        pipe = InPaint(self.model, n_steps=self.steps, ddim_eta=self.ddim_eta)
        with fp32_compute(self.device, autotune=False):
            return self._out(pipe(
                orig_img, self.cond([prompt] * batch), mask=mask,
                strength=strength, uncond_scale=uncond_scale,
                uncond=self.cond([""] * batch),
                generator=self._generator(generator)))
