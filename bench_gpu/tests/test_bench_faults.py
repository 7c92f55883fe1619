"""Whole runs past the look for a card, on the CPU at a tiny size (float32,
where the sound program passes its check), with the timed path broken
underneath: ``correct`` comes out false for each fault the cell can have
(an answer altered where it is produced, half of the batch left out, a
step that leaves its state unchanged). One card, so no exchange between
chips to leave out."""

import json

import pytest
import torch

import bench_gpu.run as run
from bench_gpu.checks import compare, over_baseline, verdict

SEED = 2 ** 34 + 9


def _serve_fault(kind):
    import diffusionmodel_tpu_torch.serving as serving

    real = serving.sample_cfg_dpmpp

    def broken(*a, **kw):
        x = real(*a, **kw)
        if kind == "altered":  # an answer altered where it is produced
            x = x.clone()
            x[..., 0] = -x[..., 0]
        elif kind == "half_batch":  # the second half of the slots left out
            x = x.clone()
            h = x.shape[0] // 2
            x[h:] = torch.as_tensor(kw["x_init"][h:]).to(x)
        return x

    return serving, "sample_cfg_dpmpp", broken


def _train_fault(kind):
    import diffusionmodel_tpu_torch.train as train

    if kind == "unchanged":  # the step returns its state unchanged
        return train, "apply_updates_", lambda *a, **kw: 0.0
    real = train.train_loss

    def half(net, x, c, mask, *a, **kw):  # half the batch, mean over the rest
        h = x.shape[0] // 2
        return real(net, x[:h], c[:h], None if mask is None else mask[:h],
                    *a, **kw)

    return train, "train_loss", half


def _txt2img_fault(kind):
    from diffusionmodel_tpu_torch.models.latent_diffusion import samplers

    real = samplers.DPMPPSampler.sample

    def broken(self, shape, cond, *a, **kw):
        x = real(self, shape, cond, *a, **kw)
        if kind == "altered":  # the latents altered where they are produced
            return -x
        h = x.shape[0] // 2  # the second half of the batch left out
        return torch.cat([x[:h], torch.zeros_like(x[h:])])

    return samplers.DPMPPSampler, "sample", broken


def _ldm_train_fault(kind):
    from diffusionmodel_tpu_torch.models.latent_diffusion import training

    if kind == "unchanged":  # the step leaves the parameters as they are
        real = training.adam

        def frozen(params, lr):
            opt = real(params, lr)
            opt.step = lambda *a, **kw: None
            return opt

        return training, "adam", frozen
    real = training.ldm_loss

    def half(unet_apply, z0, cond, *a, **kw):
        return real(unet_apply, z0[:1], cond[:1], *a, **kw)

    return training, "ldm_loss", half


FAULTS = {"context_unet": {"serve_closed_loop": _serve_fault,
                           "train_steps": _train_fault},
          "latent_diffusion": {"txt2img_closed_loop": _txt2img_fault,
                               "ldm_train_steps": _ldm_train_fault}}

CASES = [("ctxunet-serve-dpmpp20", None), ("ctxunet-serve-dpmpp20", "altered"),
         ("ctxunet-serve-dpmpp20", "half_batch"),
         ("ctxunet-train-bf16", None), ("ctxunet-train-bf16", "unchanged"),
         ("ctxunet-train-bf16", "half_batch"),
         ("sd-txt2img-dpmpp20", None), ("sd-txt2img-dpmpp20", "altered"),
         ("sd-txt2img-dpmpp20", "half_batch"),
         ("sd-train-512", None), ("sd-train-512", "unchanged"),
         ("sd-train-512", "half_batch")]


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_turns_correct_false(tiny_cell, monkeypatch, capsys, name,
                                   fault):
    if name.startswith("ctxunet-serve"):
        # every request pinned and compared, so that a fault in any slot
        # reaches the check
        cell = tiny_cell(name, clients=2, max_batch=2, warm_batches=1,
                         pinned_share=1.0, program={"sample.dpm_steps": 3})
        cell.limits["requests"] = 10 ** 6
    elif name.startswith("ctxunet-train"):
        cell = tiny_cell(name, accum_steps=2, micro_batch=2, pool_batches=4)
    elif name.startswith("sd-txt2img"):
        cell = tiny_cell(name, steps=3)
    else:
        cell = tiny_cell(name, images=4)
    if fault:
        patch = FAULTS[cell.config["family"]][cell.traffic["driver"]]
        monkeypatch.setattr(*patch(fault))
    rc = run.run(cell, SEED, 1.5, False, torch.device("cpu"))
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is (fault is None), res["checks"]


def test_baseline_of_one_step_scales_the_first_steps_numbers():
    """A baseline that follows only the first step gives the first step's
    numbers, and each of the program's is read over it; a reading over
    its limit comes out not correct (as a control's has to)."""
    want = {"loss": [2.0, 1.0, 1.0], "grad": {"a": 1.0, "b": 2.0, "c": 4.0},
            "change": {"a": 1.0, "b": 1.0, "c": 1.0}}
    got = {"loss": [2.2, 1.0, 1.0], "grad": {"a": 1.2, "b": 2.2, "c": 4.4},
           "change": {"a": 1.0, "b": 1.0, "c": 1.0}}
    one = {"loss": [2.02], "grad": {"a": 1.02, "b": 2.02, "c": 4.04},
           "change": {"a": 0.3, "b": 0.3, "c": 0.3}}
    gaps = compare(got, want, 1e-3)
    assert gaps["change_gap"] == 0.0
    base = compare(one, want, 1e-3)
    assert set(base) == {"loss1_rel", "grad_gap", "grad_gap_median"}
    ratios = over_baseline(gaps, base)
    assert set(ratios) == {f"{n}_over_baseline" for n in base}
    assert ratios["loss1_rel_over_baseline"] == pytest.approx(10.0)
    assert ratios["grad_gap_median_over_baseline"] == pytest.approx(10.0)
    limits = {"grad_gap_median_over_baseline": 5.0}
    assert verdict({**gaps, **ratios}, limits)["correct"] is False
    assert verdict(over_baseline(base, base), limits)["correct"] is True
