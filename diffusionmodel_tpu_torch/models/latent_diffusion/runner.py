"""User-facing LDM runner (counterpart of
``diffusionmodel_tpu/models/latent_diffusion/runner.py``): builds the
stable-diffusion stack once and exposes txt2img / img2img / inpaint, as
``--mode txt2img|img2img|inpaint`` of the CLI does.

- Conditioning: the CLIP text encoder (``CLIPTextEmbedder``) when one is
  given, or for the SD-sized ``d_cond`` (768) when transformers and local
  CLIP weights load; otherwise, as in the JAX package, its documented
  fallback, a prompt-hashed Gaussian embedding of shape [B, 77, d_cond]
  (bit-identical to the JAX package's).
- SDXL (``sdxl``, ``sdxl-tiny``) is conditioned on the pair (context, y),
  as sgm's ``GeneralConditioner`` builds it, with the prompt hash in place
  of its two text encoders (CLIP ViT-L/14 and OpenCLIP ViT-bigG/14, whose
  weights the repository does not hold): the prompt's hash state draws the
  context [77, d_cond] (the prompt-hash embedding, bit for bit), then the
  pooled text vector [d_pooled]. y is the pooled vector followed by the
  256-wide sinusoidal embedding (cos before sin) of each of the original
  size (h, w), the crop's top-left corner (0, 0) and the target size (h,
  w). The unconditional branch has zero context and pooled vector and the
  same size embeddings (sgm's ``force_uc_zero_embeddings=["txt"]``).
  Latents are scaled by 0.13025; images are 1024 px by default.
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
from typing import Optional, Tuple, Union

import numpy as np
import torch

from diffusionmodel_tpu_torch import tracing
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
from diffusionmodel_tpu_torch.models.latent_diffusion.unet import (
    UNetModel,
    sinusoidal_time_emb,
)

# The JAX package's architectures: "sd" is SD-v1 (860M UNet), "tiny" a
# CPU-testable miniature of the same topology, "mid" ~1/10 of "sd". The
# port's own: "sdxl" is SDXL base 1.0's UNet (sgm's
# configs/inference/sd_xl_base.yaml, 2,567,463,684 parameters) with the
# same f=8 VAE, "sdxl-tiny" a CPU-testable miniature of its topology
# (its gate lets a 64 px call take both self-attention paths). SDXL's
# flash gate is 1024: at its level-2 site (2, 1024, 20, 64) the kernel
# took 0.217 ms against the plain path's 0.598 (NVIDIA H100 SXM,
# tools/sdxl_probe.py).
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
    "sdxl": dict(channels=320, channel_multipliers=(1, 2, 4),
                 attention_levels=(1, 2), tf_layers=(0, 2, 10), d_head=64,
                 linear_proj=True, d_cond=2048, adm_in_channels=2816,
                 flash_min_seq=1024, ae_channels=128, ae_mults=(1, 2, 4, 4),
                 scale_factor=0.13025, size=1024),
    "sdxl-tiny": dict(channels=32, channel_multipliers=(1, 2, 4),
                      attention_levels=(1, 2), tf_layers=(0, 1, 2),
                      d_head=16, linear_proj=True, d_cond=32,
                      adm_in_channels=16 + 1536, flash_min_seq=16,
                      ae_channels=32, ae_mults=(1, 1, 2, 2),
                      scale_factor=0.13025, size=64),
}
SIZE_EMB = 256  # width of each size number's embedding in y
SIZE_NUMBERS = 6  # original (h, w), crop (top, left), target (h, w)


def _prompt_seed(prompt: str) -> int:
    return int.from_bytes(
        hashlib.sha256(prompt.encode("utf-8")).digest()[:4], "little")


def _hash_text(prompts, d_cond: int, d_pooled: int, max_length: int = 77
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic prompts -> ([B, 77, d_cond] context, [B, d_pooled]
    pooled vector), both drawn by the prompt's hash state in that order."""
    ctx, pooled = [], []
    for p in prompts:
        rs = np.random.RandomState(_prompt_seed(p))
        ctx.append(rs.randn(max_length, d_cond).astype(np.float32))
        pooled.append(rs.randn(d_pooled).astype(np.float32))
    return np.stack(ctx), np.stack(pooled)


def _hash_embedding(prompts, d_cond: int, max_length: int = 77) -> np.ndarray:
    """Deterministic prompt -> [B, 77, d_cond] Gaussian embedding (the
    no-CLIP fallback; the same prompt gives the same conditioning)."""
    return _hash_text(prompts, d_cond, 0, max_length)[0]


def size_embedding(sizes: torch.Tensor) -> torch.Tensor:
    """[B, k] numbers -> [B, k·256]: each number's sinusoidal embedding,
    cos before sin (sgm's ``ConcatTimestepEmbedderND``)."""
    b, k = sizes.shape
    return sinusoidal_time_emb(sizes.reshape(-1), SIZE_EMB).reshape(
        b, k * SIZE_EMB)


def sdxl_vector(pooled: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """y [B, d_pooled + 6·256] of images of ``size`` (h, w), uncropped."""
    h, w = size
    sizes = torch.tensor([h, w, 0, 0, h, w], dtype=torch.float32,
                         device=pooled.device)
    return torch.cat([pooled, size_embedding(
        sizes.expand(pooled.shape[0], SIZE_NUMBERS))], dim=1)


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
    prompt hash serves when it does not load. The SDXL archs take the
    prompt hash alone (module docstring)."""

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
        scale_factor = a.pop("scale_factor", 0.18215)
        self.size = a.pop("size", 512)
        self.arch, self.d_cond = arch, a["d_cond"]
        adm = a.get("adm_in_channels")
        self.d_pooled = adm - SIZE_NUMBERS * SIZE_EMB if adm else None
        if self.d_pooled is not None and (payload is not None
                                          or embedder is not None):
            raise ValueError(f"arch {arch!r} is conditioned on the prompt "
                             "hash's (context, y) pair; it takes no native "
                             "checkpoint and no embedder")
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
                                     self.ae.decode, device=self.device,
                                     latent_scaling_factor=scale_factor)
        self.embedder = embedder
        if embedder is None and use_clip and self.d_cond == 768:
            self.embedder = _clip_or_none(self.device, self._log)

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(msg)

    def cond(self, prompts, size: Optional[Tuple[int, int]] = None):
        """The conditioning of ``prompts``: [B, 77, d_cond]; for the SDXL
        archs the pair (context, y) of images of ``size`` (h, w; default
        the arch's)."""
        with tracing.span("ldm.cond"):
            if self.embedder is not None:
                return self.embedder(list(prompts)).to(self.device,
                                                       torch.float32)
            if self.d_pooled is None:
                return torch.from_numpy(_hash_embedding(
                    list(prompts), self.d_cond)).to(self.device)
            ctx, pooled = _hash_text(list(prompts), self.d_cond,
                                     self.d_pooled)
            return (torch.from_numpy(ctx).to(self.device), sdxl_vector(
                torch.from_numpy(pooled).to(self.device),
                size or (self.size, self.size)))

    def uncond(self, batch: int, size: Optional[Tuple[int, int]] = None):
        """The unconditional branch: the empty prompt's conditioning; for
        the SDXL archs zero context and pooled vector beside the size
        embeddings of ``size``."""
        if self.d_pooled is None:
            return self.cond([""] * batch)
        with tracing.span("ldm.cond"):
            pooled = torch.zeros(batch, self.d_pooled, device=self.device)
            return (torch.zeros(batch, 77, self.d_cond, device=self.device),
                    sdxl_vector(pooled, size or (self.size, self.size)))

    def _generator(self, generator):
        if generator is not None:
            return generator
        return torch.Generator(device=self.device).manual_seed(0)

    @staticmethod
    def _out(x: torch.Tensor) -> np.ndarray:
        with tracing.span("ldm.out"):
            return x.float().cpu().numpy()

    def txt2img(self, prompt: str, batch_size: int = 1,
                h: Optional[int] = None, w: Optional[int] = None,
                uncond_scale: float = 7.5,
                generator: Optional[torch.Generator] = None,
                skip_steps: int = 0) -> np.ndarray:
        """prompt -> [B, h, w, 3] images in about [-1, 1] (h, w default to
        the arch's size: 512, 1024 for ``sdxl``). ``skip_steps`` (DDIM,
        DDPM) runs only the last steps of the schedule. With ``tracing``
        on, the call records ``ldm.txt2img`` around ``ldm.cond`` (twice),
        the pipeline's spans and ``ldm.out``."""
        h, w = h or self.size, w or self.size
        pipe = Txt2Img(self.model, sampler=self.sampler_name,
                       n_steps=self.steps, ddim_eta=self.ddim_eta)
        with tracing.span("ldm.txt2img", images=batch_size), \
                fp32_compute(self.device, autotune=False):
            return self._out(pipe(
                self.cond([prompt] * batch_size, (h, w)),
                batch_size=batch_size, h=h, w=w, uncond_scale=uncond_scale,
                uncond=self.uncond(batch_size, (h, w)),
                generator=self._generator(generator),
                skip_steps=skip_steps))

    def img2img(self, orig_img: np.ndarray, prompt: str,
                strength: float = 0.75, uncond_scale: float = 5.0,
                generator: Optional[torch.Generator] = None) -> np.ndarray:
        """[B,H,W,3] image in [-1, 1] + prompt -> repainted images."""
        batch, size = int(orig_img.shape[0]), tuple(orig_img.shape[1:3])
        pipe = Img2Img(self.model, n_steps=self.steps, ddim_eta=self.ddim_eta)
        with fp32_compute(self.device, autotune=False):
            return self._out(pipe(
                orig_img, self.cond([prompt] * batch, size),
                strength=strength, uncond_scale=uncond_scale,
                uncond=self.uncond(batch, size),
                generator=self._generator(generator)))

    def inpaint(self, orig_img: np.ndarray, prompt: str,
                mask: Optional[np.ndarray] = None, strength: float = 0.75,
                uncond_scale: float = 5.0,
                generator: Optional[torch.Generator] = None) -> np.ndarray:
        """Masked repaint; ``mask`` is a [B,h/8,w/8,4] latent keep-mask
        (1 = keep the original), by default the bottom half."""
        batch, size = int(orig_img.shape[0]), tuple(orig_img.shape[1:3])
        pipe = InPaint(self.model, n_steps=self.steps, ddim_eta=self.ddim_eta)
        with fp32_compute(self.device, autotune=False):
            return self._out(pipe(
                orig_img, self.cond([prompt] * batch, size), mask=mask,
                strength=strength, uncond_scale=uncond_scale,
                uncond=self.uncond(batch, size),
                generator=self._generator(generator)))
