"""SDXL base 1.0 through the port's LDM path, held to the plain reference
(``bench_gpu/reference/sdxl.py``) on seeded random weights at the
``sdxl-tiny`` size on the CPU; the published ``sdxl`` arch on the meta
device only (parameter count, sgm's checkpoint names and shapes).

Tolerances: the port and the reference compute the same float32
arithmetic on the CPU, in orders that may differ (einsum attention over
the batch against one sample at a time, channels_last convolutions
against NCHW; at this size they agree to the bit), so 1e-5 leaves room
for the rounding of a few dozen layers and fails on any wrong term (a
missing vector condition moves the output by 0.2). Three sampler steps and the
decoder amplify that rounding, so the image is held to 1e-4. The
conditioning is computed by the same float32 operations on both sides and
is held bit for bit.
"""

import hashlib
import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_gpu.reference import sdxl as ref
from bench_gpu.weights import derive, fill_
from diffusionmodel_tpu_torch import tracing
from diffusionmodel_tpu_torch.models.latent_diffusion import runner as trunner
from diffusionmodel_tpu_torch.models.latent_diffusion.runner import (
    ARCHS,
    LdmRunner,
)
from diffusionmodel_tpu_torch.models.latent_diffusion.unet import UNetModel

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "bench_gpu" / "configs" / "sdxl_base_1024.json"
SEED = 2 ** 33 + 21
PX = 64  # sdxl-tiny's size: 8 x 8 latents, 16 tokens at level 1, 4 at 2


def _tiny_cfg():
    """The benchmark's configuration at sdxl-tiny's shapes."""
    cfg = json.loads(CONFIG.read_text())
    a = ARCHS["sdxl-tiny"]
    cfg["arch"], cfg["image_size"] = "sdxl-tiny", PX
    cfg["unet"].update(model_channels=a["channels"],
                       channel_mult=list(a["channel_multipliers"]),
                       transformer_depth=list(a["tf_layers"]),
                       transformer_depth_middle=a["tf_layers"][-1],
                       num_head_channels=a["d_head"],
                       context_dim=a["d_cond"],
                       adm_in_channels=a["adm_in_channels"],
                       flash_min_seq=a["flash_min_seq"])
    cfg["autoencoder"].update(channels=a["ae_channels"],
                              ch_mults=list(a["ae_mults"]))
    return cfg


@pytest.fixture(scope="module")
def pair():
    """(runner, reference stack) of sdxl-tiny with the same seeded
    weights."""
    cfg = _tiny_cfg()
    run = LdmRunner(arch="sdxl-tiny", sampler="dpmpp", steps=3,
                    verbose=False, device="cpu", use_clip=False)
    fill_(run.unet, derive(SEED, 11))
    fill_(run.ae, derive(SEED, 12))
    with torch.device("cpu"):
        stack = ref.Stack(cfg)
    fill_(stack.unet, derive(SEED, 11))
    fill_(stack.ae, derive(SEED, 12))
    return run, stack.eval(), cfg


def _meta_unet(arch):
    a = dict(ARCHS[arch])
    for k in ("ae_channels", "ae_mults", "scale_factor", "size"):
        a.pop(k, None)
    with torch.device("meta"):
        return UNetModel(**a)


def _rel(got, want):
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    return float((got - want).norm() / want.norm())


def test_sdxl_unet_has_the_published_count_and_sgm_names():
    unet = _meta_unet("sdxl")
    assert sum(p.numel() for p in unet.parameters()) == 2_567_463_684
    shapes = {k: tuple(v.shape) for k, v in unet.state_dict().items()}
    assert shapes["label_emb.0.0.weight"] == (1280, 2816)
    assert shapes["label_emb.0.2.weight"] == (1280, 1280)
    assert shapes["input_blocks.4.1.proj_in.weight"] == (640, 640)
    assert shapes["middle_block.1.transformer_blocks.9.attn2.to_k.weight"] \
        == (1280, 2048)
    assert shapes["output_blocks.2.2.conv.weight"] == (1280, 1280, 3, 3)
    assert "input_blocks.1.1.norm.weight" not in shapes  # no level-0 attn
    n_blocks = {k.split(".transformer_blocks.")[0] + "." + k.split(
        ".transformer_blocks.")[1].split(".")[0] for k in shapes
        if ".transformer_blocks." in k}
    assert len(n_blocks) == 70
    # the reference builds the same names and shapes from sgm's keys
    with torch.device("meta"):
        stack = ref.Stack(json.loads(CONFIG.read_text()))
    assert {k: tuple(v.shape) for k, v in stack.unet.state_dict().items()} \
        == shapes


def test_sd_arch_keeps_its_state_dict():
    """The SD-v1 arch builds what it built before the SDXL options: 1x1
    convolution projections, one block a level, 8 heads, no label_emb."""
    sd = _meta_unet("sd").state_dict()
    shapes = {k: tuple(v.shape) for k, v in sd.items()}
    assert sum(np.prod(s) for s in shapes.values()) == 859_520_964
    assert len(shapes) == 686
    # every key and shape, in order, as the module built them before
    assert hashlib.sha256(repr(list(shapes.items())).encode()).hexdigest(
    )[:16] == "ce441dccbce38539"
    assert shapes["input_blocks.1.1.proj_in.weight"] == (320, 320, 1, 1)
    assert shapes["output_blocks.11.1.proj_out.weight"] == (320, 320, 1, 1)
    assert shapes["middle_block.1.transformer_blocks.0.attn2.to_k.weight"] \
        == (1280, 768)
    assert not any(k.startswith("label_emb") for k in shapes)
    assert not any(".transformer_blocks.1." in k for k in shapes)


def test_config_gate_is_the_arch_gate():
    """The benchmark counts flash sites at the gate the runner uses."""
    cfg = json.loads(CONFIG.read_text())
    assert cfg["unet"]["flash_min_seq"] == ARCHS["sdxl"].get(
        "flash_min_seq", 2048)
    assert cfg["schedule"]["scale_factor"] == ARCHS["sdxl"]["scale_factor"]


def test_conditioning_is_the_reference_bit_for_bit(pair):
    run, _, cfg = pair
    prompts = ["a crack", "a cat in a hat"]
    cond, uncond = run.cond(prompts, (PX, 96)), run.uncond(2, (PX, 96))
    want, want_u = ref.conditioning(cfg, prompts, PX, 96, "cpu")
    for got, exp in zip(cond + uncond, want + want_u):
        assert torch.equal(got, exp)
    # the context is the prompt-hash embedding SD-v1 uses, bit for bit
    np.testing.assert_array_equal(cond[0].numpy(), trunner._hash_embedding(
        prompts, cfg["unet"]["context_dim"]))
    # y: pooled [16], then original (h, w), crop (0, 0), target (h, w)
    d_pooled = 16
    y = cond[1]
    assert y.shape == (2, d_pooled + 6 * 256)
    emb = y[:, d_pooled:].reshape(2, 6, 256)
    half = torch.arange(128, dtype=torch.float32)
    freqs = torch.exp(-np.log(10000) * half / 128)
    for i, v in enumerate((PX, 96, 0, 0, PX, 96)):
        assert torch.allclose(emb[:, i, :128], torch.cos(v * freqs))
        assert torch.allclose(emb[:, i, 128:], torch.sin(v * freqs))


def test_uncond_zeroes_the_text_and_keeps_the_sizes(pair):
    run, _, _ = pair
    (ctx, y), (uctx, uy) = run.cond(["a crack"], (PX, PX)), \
        run.uncond(1, (PX, PX))
    assert uctx.shape == ctx.shape and not uctx.any()
    assert not uy[:, :16].any()
    assert torch.equal(uy[:, 16:], y[:, 16:])


def test_unet_forward_with_y_matches_the_reference(pair):
    run, stack, _ = pair
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, PX // 8, PX // 8, 4, generator=g)
    t = torch.tensor([3, 901])
    cond = run.cond(["a crack", "a cat in a hat"], (PX, PX))
    with torch.no_grad():
        got = run.unet(x, t, cond)
        want = stack.unet(x, t, cond)
        without_y = stack.unet(x, t, (cond[0], torch.zeros_like(cond[1])))
    assert _rel(got, want) < 1e-5
    assert _rel(without_y, want) > 1e-2  # y is a term the check sees
    with pytest.raises(ValueError):
        run.unet(x, t, cond[0])


def test_txt2img_matches_the_reference_sampler_and_decoder(pair):
    run, stack, cfg = pair
    prompt, scale, gseed = "a longitudinal crack", 5.0, 2 ** 40 + 3
    got = run.txt2img(prompt, batch_size=1, uncond_scale=scale,
                      generator=torch.Generator().manual_seed(gseed))
    assert got.shape == (1, PX, PX, 3)
    cond, uncond = ref.conditioning(cfg, [prompt], PX, PX, "cpu")
    x = torch.randn((1, PX // 8, PX // 8, 4),
                    generator=torch.Generator().manual_seed(gseed))
    abar = ref.alpha_bar(cfg, "cpu")
    z = ref.sample_dpmpp_pair(stack.unet, x, cond, uncond, scale, abar, 3)
    with torch.no_grad():
        want = stack.ae.decode(z)
    assert _rel(got, want) < 1e-4


def test_recorder_sees_transformer_spans_and_both_attention_paths(pair):
    """sdxl-tiny at 64 px: level 1 (16 tokens) at the gate takes the flash
    path, level 2 (4 tokens) the plain one; 11 SpatialTransformers a UNet
    call (2 + 2 down, 1 middle, 3 + 3 up), 3 calls."""
    run, _, _ = pair
    tracing.drain()
    tracing.enable()
    try:
        run.txt2img("a crack", batch_size=1, uncond_scale=5.0)
    finally:
        tracing.disable()
    spans, _ = tracing.drain()
    names = Counter(s.name for s in spans)
    assert names["ldm.transformer"] == 33
    by_tokens = Counter((s.ids["tokens"], s.ids["depth"]) for s in spans
                        if s.name == "ldm.transformer")
    assert by_tokens == {(16, 1): 15, (4, 2): 18}
    steps = {s.id for s in spans if s.name == "sample.step"}
    assert all(s.parent in steps for s in spans
               if s.name == "ldm.transformer")


def test_recorder_counts_each_self_attention_by_its_path(pair):
    run, _, _ = pair
    _, before = tracing.drain()
    tracing.enable()
    try:
        run.txt2img("a crack", batch_size=1, uncond_scale=5.0)
    finally:
        tracing.disable()
    _, after = tracing.drain()
    inc = {k: after[k] - before.get(k, 0) for k in after
           if after[k] != before.get(k, 0)}
    # level 1: 5 transformers of depth 1; level 2 and middle: 6 of depth 2
    assert inc == {"ldm.attn_flash_calls": 15, "ldm.attn_plain_calls": 36}


def test_sdxl_refuses_what_it_cannot_take(tmp_path):
    from diffusionmodel_tpu_torch.cli import main

    with pytest.raises(ValueError):
        LdmRunner(arch="sdxl-tiny", verbose=False, device="cpu",
                  embedder=lambda p: None)
    assert main(["--mode", "train_ldm", "--data_root", str(tmp_path),
                 "--ldm_arch", "sdxl-tiny", "--device", "cpu"]) == 1


def test_sdxl_checkpoint_names_load_as_they_are(tmp_path, pair):
    """An sgm-named checkpoint (``model.diffusion_model.*``,
    ``first_stage_model.*`` and the conditioner's keys, which nothing
    reads) loads into the runner with no key missing."""
    run, _, _ = pair
    sd = {"model.diffusion_model." + k: v.clone() + 1.0
          for k, v in run.unet.state_dict().items()}
    sd.update({"first_stage_model." + k: v.clone()
               for k, v in run.ae.state_dict().items()})
    sd["conditioner.embedders.0.transformer.text_model.x"] = torch.zeros(1)
    path = tmp_path / "sd_xl_tiny.ckpt"
    torch.save({"state_dict": sd}, path)
    loaded = LdmRunner(sd_ckpt=str(path), arch="sdxl-tiny", verbose=False,
                       device="cpu")
    for k, v in loaded.unet.state_dict().items():
        assert torch.equal(v, sd["model.diffusion_model." + k]), k
