"""SDXL base 1.0 at its published widths on the card: one 1024 px txt2img
through ``LdmRunner(arch="sdxl")`` (DPM-Solver++, 4 steps, guidance 5)
held to the plain float32 reference (``bench_gpu/reference/sdxl.py``) on
the benchmark's seeded weights, by the relative L2 limit of the
benchmark's ``sdxl-txt2img-dpmpp20`` cell (``bench_gpu/limits/``): the
limit at which the reference computed in TF32, below the configuration's
float32, fails. Four steps amplify the rounding less than the cell's
twenty, so the limit holds with room.

Marked ``cuda``: every test here skips where CUDA is absent (the CPU
tier). On a machine with a card, where JAX is not installed, run it
without the repository's conftest (it imports jax):

    python -m pytest --noconftest tests/test_torch_sdxl_cuda.py -q
"""

import gc
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

pytestmark = pytest.mark.cuda

CELL = "sdxl-txt2img-dpmpp20"
SEED = 2 ** 34 + 5
STEPS = 4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def test_sdxl_txt2img_1024_matches_the_reference(dev):
    from bench_gpu import harness
    from bench_gpu.drivers.serve_closed_loop import image_gap
    from bench_gpu.families import sdxl as fam
    from bench_gpu.reference import lowp
    from bench_gpu.reference import sdxl as ref
    from diffusionmodel_tpu_torch import tracing

    cell = harness.find_cell(harness.load_spec(), CELL, False)
    cfg, tr = cell.config, cell.traffic
    px, prompt, gseed = cfg["image_size"], tr["prompts"][0], SEED + 1
    runner = fam.build_program(cfg, SEED, dev, "dpmpp", STEPS)
    _, before = tracing.drain()
    tracing.enable()
    try:
        got = runner.txt2img(prompt, batch_size=1, uncond_scale=tr["scale"],
                             generator=torch.Generator(dev).manual_seed(
                                 gseed))
    finally:
        tracing.disable()
    _, after = tracing.drain()
    assert got.shape == (1, px, px, 3)
    del runner
    gc.collect()
    torch.cuda.empty_cache()

    stack = fam.build_reference(cfg, SEED, dev).eval()
    cond, uncond = ref.conditioning(cfg, [prompt], px, px, dev)
    x = torch.randn((1, px // 8, px // 8, 4),
                    generator=torch.Generator(dev).manual_seed(gseed),
                    device=dev)
    with lowp.tf32_allowed(False), torch.no_grad():
        z = ref.sample_dpmpp_pair(stack.unet, x, cond, uncond, tr["scale"],
                                  ref.alpha_bar(cfg, dev), STEPS)
        want = stack.ae.decode(z).cpu().numpy()
    gap = image_gap(got, want)
    limit = cell.limits["compared"]["image_rel_l2"]
    print(json.dumps({"image_rel_l2": gap, "limit": limit}))
    assert gap <= limit

    # level 1 (4096 tokens, 10 heads of 64): 5 transformers of depth 2 a
    # UNet call take the flash path; level 2 and the middle (1024 tokens)
    # take it only where the configuration's gate admits them
    u = cfg["unet"]
    per_call = 5 * u["transformer_depth"][1]
    level2 = 5 * u["transformer_depth"][2] + u["transformer_depth_middle"]
    flash = after.get("ldm.attn_flash_calls", 0) \
        - before.get("ldm.attn_flash_calls", 0)
    plain = after.get("ldm.attn_plain_calls", 0) \
        - before.get("ldm.attn_plain_calls", 0)
    if u["flash_min_seq"] <= (px // 32) ** 2:
        per_call, level2 = per_call + level2, 0
    assert (flash, plain) == (STEPS * per_call, STEPS * level2)
