"""The plain reference against the port's plain path at tiny sizes on the
CPU (float32, where both should agree to rounding): the denoiser, the
DPM++ sampler, the training loss's draws and three optimizer steps."""

import numpy as np
import pytest
import torch

from bench_gpu.families import context_unet as fam
from bench_gpu.reference import diffusion as refdiff
from bench_gpu.reference import lowp
from bench_gpu.reference.context_unet import set_quant

SEED = 2 ** 33 + 17


@pytest.fixture
def tiny_cfg(tiny_cell):
    return tiny_cell("ctxunet-train-bf16").config


def _inputs(b=3, s=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, s, s, 3, generator=g)
    c = torch.tensor([0, 3, 4][:b])
    t = torch.rand(b, generator=g)
    keep = torch.tensor([1.0, 0.0, 1.0][:b])
    mask = torch.tensor([0.5, 1.0, 3.0])[torch.randint(0, 3, (b, s, s),
                                                       generator=g)]
    return x, c, t, keep, mask


def test_seeded_weights_are_the_same_on_both_sides(tiny_cfg):
    _, prog, _ = fam.build_program(tiny_cfg, SEED, "cpu")
    ref = fam.build_reference(tiny_cfg, SEED, "cpu")
    p = dict(prog.named_parameters())
    for n, q in ref.named_parameters():
        assert torch.equal(p[n].detach(), q.detach()), n


@pytest.mark.parametrize("with_mask", [False, True])
def test_reference_forward_matches_the_port(tiny_cfg, with_mask):
    _, prog, _ = fam.build_program(tiny_cfg, SEED, "cpu")
    ref = fam.build_reference(tiny_cfg, SEED, "cpu")
    x, c, t, keep, mask = _inputs()
    am = mask if with_mask else None
    prog.train(with_mask)
    with torch.no_grad():
        got = prog(x, c, t, keep, am).float()
        want = ref(x, c, t, keep, am)
    rel = (got - want).norm() / want.norm()
    assert rel < 1e-5


def test_control_moves_the_reference(tiny_cfg):
    ref = fam.build_reference(tiny_cfg, SEED, "cpu")
    x, c, t, keep, _ = _inputs()
    with torch.no_grad():
        want = ref(x, c, t, keep)
        set_quant(ref, lowp.fp8)
        low = ref(x, c, t, keep)
    assert float((low - want).norm() / want.norm()) > 1e-2


def test_reference_sampler_matches_the_port(tiny_cfg):
    from diffusionmodel_tpu_torch.diffusion import sample_cfg_dpmpp

    pc, prog, sched = fam.build_program(tiny_cfg, SEED, "cpu")
    ref = fam.build_reference(tiny_cfg, SEED, "cpu").eval()
    dc = tiny_cfg["diffusion"]
    x = torch.from_numpy(np.concatenate(
        [refdiff.start_noise(s, 1, 32, 3) for s in (5, 2 ** 40)]))
    classes = torch.tensor([1, 4])
    guide = torch.tensor([2.0, 6.0])
    got = sample_cfg_dpmpp(prog, None, 2, (32, 32, 3), 5, sched, pc.diffusion,
                           guide_w=guide, n_steps=4, classes=classes,
                           x_init=x)
    sch = refdiff.schedule(dc["beta1"], dc["beta2"], dc["n_T"], "cpu")
    want = refdiff.sample_dpmpp(ref, x.clone(), classes, guide,
                                sch["abar64"], dc["n_T"], 4)
    assert float((got - want).norm() / want.norm()) < 1e-4


def test_reference_draws_are_the_ports():
    from diffusionmodel_tpu_torch.config import DiffusionConfig
    from diffusionmodel_tpu_torch.diffusion import loss_draws

    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    for _ in range(2):
        a = loss_draws(DiffusionConfig(), (4, 8, 8, 3), g1, "cpu")
        b = refdiff.draws(g2, 4, (4, 8, 8, 3), 700, 0.1, "cpu")
        assert torch.equal(a["ts"], b["ts"])
        assert torch.equal(a["noise"], b["noise"])
        assert torch.equal(a["ctx_mask"], b["keep"])


def test_reference_steps_match_the_port(tiny_cell):
    """The training driver's own check at float32: program and reference
    take the same three steps."""
    from bench_gpu import harness
    from bench_gpu.checks import compare

    cell = tiny_cell("ctxunet-train-bf16", accum_steps=2, micro_batch=2,
                     pool_batches=4)
    sess = harness.driver(cell).Session(cell, SEED, torch.device("cpu"))
    sess.warm()
    got = sess.readings
    sess.window_steps, sess.window_failed = 0, 0
    sess.free()
    gaps = compare(got, sess.reference(), cell.limits["skip_below"])
    assert gaps["loss_rel"] < 1e-5
    assert gaps["grad_gap"] < 1e-3
    assert gaps["change_gap"] < 1e-2
