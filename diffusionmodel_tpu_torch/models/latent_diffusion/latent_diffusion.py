"""Latent diffusion composition (counterpart of
``diffusionmodel_tpu/models/latent_diffusion/latent_diffusion.py``).

beta = linspace(sqrt(beta_start), sqrt(beta_end), T)², built in fp32 as
the JAX package builds it (fp32 linspace, squared, fp32 cumprod); the two
agree to fp32 rounding (the cumprod's order differs), not bit for bit.
Latents are scaled by 0.18215 (SD-v1; SDXL's VAE takes 0.13025).

``CLIPTextEmbedder`` is the text encoder (HF CLIP ViT-L/14,
reference clip_embedder.py:20-50) through transformers' PyTorch
``CLIPTokenizer`` / ``CLIPTextModel``, imported when it is built. It reads
local weights only (no download): where transformers or the weights are
missing, ``LdmRunner`` conditions through the prompt hash instead, as the
JAX package does.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import torch

from diffusionmodel_tpu_torch.device_check import resolve_device


class LdmSchedule(NamedTuple):
    beta: torch.Tensor
    alpha: torch.Tensor
    alpha_bar: torch.Tensor


def ldm_schedule(n_steps: int = 1000, linear_start: float = 0.00085,
                 linear_end: float = 0.0120,
                 device: Optional[Union[str, torch.device]] = None
                 ) -> LdmSchedule:
    """The schedule's tensors on ``device`` (``None``: the GPU, which must
    be present; pass ``"cpu"`` for the CPU)."""
    beta = torch.linspace(linear_start ** 0.5, linear_end ** 0.5, n_steps,
                          dtype=torch.float32,
                          device=resolve_device(device)) ** 2
    alpha = 1.0 - beta
    return LdmSchedule(beta, alpha, torch.cumprod(alpha, dim=0))


class CLIPTextEmbedder:
    """Prompts -> [B, 77, d] ``last_hidden_state`` on the model's device:
    tokenize, truncate and pad to ``max_length`` (77), encode.

    With no ``tokenizer`` / ``model`` given, loads ``model_name`` with
    transformers' ``CLIPTokenizer`` / ``CLIPTextModel`` from the local
    cache only (``local_files_only``) onto ``device`` (default CUDA,
    raising without it unless ``device="cpu"``); a missing package or
    missing weights raise. Given ones (a tiny random-config model in the
    tests) are used as they are."""

    def __init__(self, model_name: str = "openai/clip-vit-large-patch14",
                 max_length: int = 77, tokenizer=None, model=None,
                 local_files_only: bool = True,
                 device: Optional[Union[str, torch.device]] = None):
        if tokenizer is None or model is None:
            from transformers import CLIPTextModel, CLIPTokenizer

            dev = resolve_device(device)
            tokenizer = tokenizer or CLIPTokenizer.from_pretrained(
                model_name, local_files_only=local_files_only)
            model = model or CLIPTextModel.from_pretrained(
                model_name, local_files_only=local_files_only).to(dev)
        self.tokenizer = tokenizer
        self.model = model.eval()
        self.max_length = max_length

    @torch.inference_mode()
    def __call__(self, prompts) -> torch.Tensor:
        toks = self.tokenizer(list(prompts), truncation=True,
                              max_length=self.max_length,
                              padding="max_length", return_tensors="pt")
        dev = next(self.model.parameters()).device
        out = self.model(input_ids=toks["input_ids"].to(dev),
                         attention_mask=toks["attention_mask"].to(dev))
        return out.last_hidden_state


class LatentDiffusion:
    """Composes an eps-model with the autoencoder's encode / decode.

    ``eps_fn(x, t, cond)`` -> eps; ``encode_fn(img)`` -> a
    GaussianDistribution; ``decode_fn(z)`` -> images. The schedule lives on
    ``device`` (``None``: the GPU, which must be present)."""

    def __init__(self, eps_fn: Callable, encode_fn: Optional[Callable] = None,
                 decode_fn: Optional[Callable] = None, n_steps: int = 1000,
                 linear_start: float = 0.00085, linear_end: float = 0.0120,
                 device: Optional[Union[str, torch.device]] = None,
                 latent_scaling_factor: float = 0.18215):
        self.latent_scaling_factor = latent_scaling_factor
        self.eps_fn = eps_fn
        self.encode_fn = encode_fn
        self.decode_fn = decode_fn
        self.n_steps = n_steps
        self.device = resolve_device(device)
        self.sched = ldm_schedule(n_steps, linear_start, linear_end,
                                  self.device)

    def autoencoder_encode(self, img, generator=None, noise=None):
        """Scaled latents of ``img``: the scale · a draw from the posterior
        (``noise`` when given, else from ``generator``)."""
        dist = self.encode_fn(img)
        return self.latent_scaling_factor * dist.sample(generator, noise)

    def autoencoder_decode(self, z):
        return self.decode_fn(z / self.latent_scaling_factor)

    def __call__(self, x, t, cond):
        return self.eps_fn(x, t, cond)
