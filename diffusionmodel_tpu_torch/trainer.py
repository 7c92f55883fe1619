"""Training orchestration (host loop) — the ``train_model`` equivalent
(new_scripy.py:659-943), counterpart of ``diffusionmodel_tpu/trainer.py``
on one device.

Per epoch: train phase (gradient accumulation, loss EMA logging),
validation phase, early-stop check (best-state stashing,
``best_model_early``), periodic sampling every ``eval_every`` epochs,
checkpointing (save_freq/min_save_ep/best), and a metrics JSON dump with
the JAX package's schema (metrics/metrics_ep{N}.json with
train_loss/val_loss/img_metrics/lr/steps_per_sec).

Checkpoints hold numpy trees in the JAX package's format (parameters and
EMA through ``compat.flax_bridge``; the optimizer state in the port's own
layout), so the JAX package's ``load_checkpoint`` reads them and
``--resume`` reads either package's. They are written by a background
thread (``_CkptWriter``) from host copies taken on the training thread.

Each sampling epoch scores the samples against the collected real images
(``metrics.ImageMetrics`` on the run's device unless ``metrics_impl`` is
given: fid or fid_proxy from 10 images per side, SSIM and PSNR when the
counts match). The textbook schedule family (the ``labml`` preset's
``ddpm_unet``) trains on its own schedule (t in [0, n_T), plain MSE) and
samples with the textbook ancestral sampler. Mesh axes and ZeRO-1 are
ROADMAP A12.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from diffusionmodel_tpu_torch.checkpoint import (
    extract_params,
    load_checkpoint,
    save_checkpoint,
)
from diffusionmodel_tpu_torch.compat.flax_bridge import load_flax
from diffusionmodel_tpu_torch.config import Config
from diffusionmodel_tpu_torch.data import (
    BatchLoader,
    CrackDataset,
    stratified_split,
)
from diffusionmodel_tpu_torch.device_check import fp32_compute, resolve_device
from diffusionmodel_tpu_torch.diffusion import (
    Schedule,
    _start_noise,
    sample_cfg,
    sample_cfg_ddim,
    sample_cfg_dpmpp,
)
from diffusionmodel_tpu_torch.lr_schedules import build_schedule
from diffusionmodel_tpu_torch.metrics import ImageMetrics
from diffusionmodel_tpu_torch.models.annotated_ddpm.diffusion import (
    make_textbook_chunk_fn,
    textbook_chunk_steps,
    textbook_schedule,
)
from diffusionmodel_tpu_torch.nn import build_model
from diffusionmodel_tpu_torch.train import (
    EarlyStop,
    TrainState,
    create_train_state,
    host_trees,
    make_eval_step,
    make_train_step,
    opt_state_from_host,
    opt_state_to_host,
)
from diffusionmodel_tpu_torch.utils.grid import save_samples


def _sanitize(obj):
    if isinstance(obj, dict):
        return {k: _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize(v) for v in obj]
    if isinstance(obj, (np.floating, np.integer)):
        return float(obj)
    if isinstance(obj, np.ndarray) and obj.size == 1:
        return float(obj)
    if isinstance(obj, torch.Tensor) and obj.numel() == 1:
        return float(obj)
    return obj


def make_sampler(cfg: Config, sched: Schedule, n_sample: int, classes=None):
    """Returns ``sampler(model, generator, guide_w, x_init=None)`` ->
    images [n_sample, H, W, C] on the schedule's device, through the
    configured sampler (``sample.sampler``: ancestral over all n_T steps,
    ddim, or dpmpp). ``guide_w`` is a scalar or one scale per sample.
    ``fit`` and ``gen_samples`` call it under ``device_check.fp32_compute``;
    another caller sets the precision flags it wants.

    The textbook family samples unconditionally with the textbook
    ancestral sampler over t = n_T-1..0 (reference/ddpm/__init__.py:
    230-255; ``classes`` and ``guide_w`` are ignored), through the adapter
    it shares with the service (``make_textbook_chunk_fn``)."""
    dc, mc, sc = cfg.diffusion, cfg.model, cfg.sample
    shape = (mc.img_size, mc.img_size, mc.in_ch)
    if dc.schedule_family == "textbook":
        def textbook(model, generator, guide_w, x_init=None) -> torch.Tensor:
            x = _start_noise(x_init, n_sample, shape, generator, sched.device)
            chunk = make_textbook_chunk_fn(model.eval(), dc, n_sample, shape)
            return chunk(x, generator, textbook_chunk_steps(dc.n_T))

        return textbook
    if sc.sampler not in ("ancestral", "ddim", "dpmpp"):
        raise ValueError(f"unknown sample.sampler {sc.sampler!r} "
                         "(expected ancestral | ddim | dpmpp)")

    def run(model, generator, guide_w, x_init):
        common = dict(guide_w=guide_w, classes=classes, x_init=x_init)
        if sc.sampler == "ddim":
            return sample_cfg_ddim(model, generator, n_sample, shape,
                                   mc.n_classes, sched, dc,
                                   n_steps=sc.ddim_steps, eta=sc.ddim_eta,
                                   discretize=sc.ddim_discretize, **common)
        if sc.sampler == "dpmpp":
            return sample_cfg_dpmpp(model, generator, n_sample, shape,
                                    mc.n_classes, sched, dc,
                                    n_steps=sc.dpm_steps,
                                    discretize=sc.ddim_discretize, **common)
        return sample_cfg(model, generator, n_sample, shape, mc.n_classes,
                          sched, dc, **common)

    def sampler(model, generator, guide_w, x_init=None) -> torch.Tensor:
        return run(model.eval(), generator, guide_w, x_init)

    return sampler


def _wire_format_ok(dataset, dc) -> bool:
    """The uint8 wire format maps mask class indices back to weights with
    the CONFIG's low/mid/high_weight (train.decode_wire). A dataset with
    other mask_values ships floats, so training uses its own weights."""
    cfg_vals = (dc.low_weight, dc.mid_weight, dc.high_weight)
    return tuple(getattr(dataset, "mask_values", cfg_vals)) == cfg_vals


class _CkptWriter:
    """Asynchronous checkpoint writer: one daemon thread, FIFO by name,
    per-name coalescing. ``submit`` hands over an already host-resident
    payload and returns; a newer payload for a queued name (e.g.
    ``best_model``) replaces the older one, so stale snapshots are skipped
    and the newest always lands. ``close()`` drains the queue."""

    def __init__(self, verbose: bool = True):
        self._cv = threading.Condition()
        # name -> (path, payload, sidecar)
        self._pending: Dict[str, tuple] = {}
        self._order: list = []                # FIFO of pending names
        self._stop = False
        self.verbose = verbose
        self.errors: list = []
        self._thread = threading.Thread(
            target=self._run, name="ckpt-writer", daemon=True)
        self._thread.start()

    def submit(self, name: str, path: str, payload: dict,
               sidecar: Optional[tuple] = None) -> None:
        """Queue a checkpoint; ``sidecar=(path, json_dict)`` is written
        after the checkpoint itself lands (it mirrors on-disk state)."""
        with self._cv:
            if name not in self._pending:
                self._order.append(name)
            self._pending[name] = (path, payload, sidecar)
            self._cv.notify()

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._order and not self._stop:
                    self._cv.wait()
                if not self._order:
                    return  # stopped and drained
                name = self._order.pop(0)
                path, payload, sidecar = self._pending.pop(name)
            t0 = time.time()
            try:
                out = save_checkpoint(path, payload)
                if sidecar is not None:
                    with open(sidecar[0], "w") as f:
                        json.dump(sidecar[1], f)
                if self.verbose:
                    print(f"[{time.strftime('%H:%M:%S')}] Saved checkpoint: "
                          f"{out} ({time.time() - t0:.1f}s, async)",
                          flush=True)
            except Exception as e:  # keep the writer alive for later saves
                self.errors.append((name, e))
                print(f"[ckpt-writer] save of {name} FAILED: {e}", flush=True)

    def close(self) -> None:
        """Drain pending writes and stop the thread (blocks)."""
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._thread.join()


def _load_params(model, params, batch_stats=None) -> None:
    """Load a flax parameter tree into ``model``; BatchNorm statistics from
    ``batch_stats``, else the model's own."""
    if not batch_stats:
        batch_stats = host_trees(model)[1]
    load_flax(model, params, batch_stats)


def _check_single_device(tc) -> None:
    multi = {k: getattr(tc, k) for k in ("mesh_data", "mesh_model",
                                         "mesh_spatial")
             if getattr(tc, k) > 1}
    if multi or tc.zero1:
        raise NotImplementedError(
            f"{dict(multi, **({'zero1': True} if tc.zero1 else {}))}: "
            "multi-device training is not ported yet: ROADMAP A12 "
            "(parallel); the port trains on one device")


def fit(cfg: Config, dataset=None, metrics_impl=None, verbose: bool = True,
        resume: Optional[str] = None, device=None) -> TrainState:
    """Train on ``device`` (default CUDA; raises without it unless
    ``device="cpu"``). ``resume`` restores the parameters, EMA, BatchNorm
    statistics, epoch and (for the port's own checkpoints) the optimizer
    state from either package's checkpoint. Returns the TrainState, with
    the best validation epoch's parameters loaded when one was kept."""
    dev = resolve_device(device)
    tc, mc, dc = cfg.train, cfg.model, cfg.diffusion
    _check_single_device(tc)
    if tc.debug_nans:
        torch.autograd.set_detect_anomaly(True)

    os.makedirs(tc.save_dir, exist_ok=True)
    metrics_dir = os.path.join(tc.save_dir, "metrics")
    os.makedirs(metrics_dir, exist_ok=True)
    metrics_log: Dict[str, list] = {
        "train_loss": [], "val_loss": [], "img_metrics": [], "lr": [],
        "steps_per_sec": [],
    }

    if dataset is None:
        dataset = CrackDataset(
            cfg.data_root, img_size=mc.img_size,
            mask_values=(dc.low_weight, dc.mid_weight, dc.high_weight),
            hflip_prob=tc.hflip_prob, co_flip_mask=tc.co_flip_mask)
    n_classes = len(dataset.classes) if dataset.classes else mc.n_classes
    if n_classes != mc.n_classes:
        cfg = cfg.replace(model=dataclasses.replace(mc, n_classes=n_classes))
        mc = cfg.model

    train_idx, val_idx = stratified_split(dataset.labels, tc.val_split,
                                          tc.split_seed)
    if verbose:
        print(f"Dataset split - Train: {len(train_idx)}, Val: {len(val_idx)}")

    wire_ok = _wire_format_ok(dataset, dc)
    train_loader = BatchLoader(dataset, train_idx, tc.batch_size,
                               tc.accum_steps, shuffle=True, augment=True,
                               seed=tc.seed, wire_u8=wire_ok)
    val_loader = BatchLoader(dataset, val_idx, tc.batch_size, 1, shuffle=False,
                             augment=False, wire_u8=wire_ok)

    torch.manual_seed(tc.seed)
    model = build_model(mc, dc.high_thresh, device=dev)
    if dc.schedule_family == "textbook":
        sched = textbook_schedule(dc.n_T, dc.beta1, dc.beta2, dev)
    else:
        sched = Schedule.create(dc.beta1, dc.beta2, dc.n_T, dev)
    steps_per_epoch = max(1, len(train_loader))
    generator = torch.Generator(device=dev).manual_seed(tc.seed)
    state, opt = create_train_state(model, cfg, steps_per_epoch)

    start_epoch = 0
    if resume:
        ckpt = load_checkpoint(resume, arch=mc.arch, norm=mc.norm)
        bs = ckpt.get("batch_stats") if isinstance(ckpt, dict) else None
        # the LIVE weights: optimization continues from them; the EMA
        # shadow is restored separately
        _load_params(model, extract_params(ckpt, prefer_ema=False), bs)
        if state.ema is not None:
            ema = ckpt.get("ema_params") if isinstance(ckpt, dict) else None
            _load_params(state.ema, ema if ema is not None
                         else extract_params(ckpt, prefer_ema=False), bs)
        if isinstance(ckpt, dict):
            if ckpt.get("opt_state") is not None:
                try:
                    opt_state_from_host(model, state.opt_state,
                                        ckpt["opt_state"])
                except Exception as e:
                    print(f"opt_state restore skipped: {e}")
            start_epoch = int(ckpt.get("epoch", -1)) + 1
        # the EMA warm-up min(decay, (1+step)/(10+step)) continues from
        # the resumed position instead of restarting at ~0.1
        state.step = start_epoch * steps_per_epoch
        if verbose:
            print(f"Resumed from {resume} at epoch {start_epoch}")
    norm_u8 = bool(getattr(dataset, "normalize", True))
    step_fn = make_train_step(model, sched, cfg, opt, normalize_u8=norm_u8)
    eval_fn = make_eval_step(model, sched, cfg, normalize_u8=norm_u8)

    # Eval-sample collection: stratified <= eval_sample_count from val
    # (new_scripy.py:747-765).
    eval_samples = []
    eval_count = min(tc.eval_sample_count, len(val_idx))
    per_class = max(2, eval_count // max(n_classes, 1))
    class_counts = {i: 0 for i in range(n_classes)}
    for i in val_idx:
        x, c, _ = dataset.load(int(i), augment=False)
        if class_counts.get(c, per_class) < per_class \
                and len(eval_samples) < eval_count:
            eval_samples.append((x, c))
            class_counts[c] += 1
        if len(eval_samples) >= eval_count:
            break
    if verbose:
        print(f"Collected {len(eval_samples)} samples for evaluation")

    sampler = None
    if eval_samples:
        classes = torch.tensor([c for _, c in eval_samples], device=dev)
        sampler = make_sampler(cfg, sched, len(eval_samples), classes=classes)
    img_metrics = (metrics_impl if metrics_impl is not None
                   else ImageMetrics(device=dev))

    early_stop = EarlyStop(tc.patience, tc.min_delta, verbose=verbose,
                           snapshot_min_epochs=tc.best_snapshot_min_epochs)
    # A resumed run must not clobber an existing best_model with a
    # worse-val state just because its EarlyStop baseline restarts at inf.
    best_sidecar = os.path.join(tc.save_dir, "best_val.json")
    if resume and os.path.exists(best_sidecar):
        try:
            with open(best_sidecar) as f:
                prev_best = json.load(f)
            early_stop.best_loss = float(prev_best["val_loss"])
            if verbose:
                print(f"EarlyStop baseline from existing best_model: "
                      f"{early_stop.best_loss:.6f} "
                      f"(epoch {prev_best.get('epoch')})")
        except Exception as e:
            print(f"best_val sidecar ignored: {e}")
    lr_schedule_fn = build_schedule(
        tc.lr_schedule, tc.lr, steps_per_epoch, n_epoch=tc.n_epoch,
        t0=tc.sgdr_t0, t_mult=tc.sgdr_t_mult, eta_min=tc.sgdr_eta_min)

    ckpt_writer = _CkptWriter(verbose=verbose)

    def save_ckpt(epoch, loss, is_best=False, host_state=None):
        name = "best_model" if is_best else f"ckpt_ep{epoch}"
        t0 = time.time()
        if host_state is not None:
            # best_model: the host copy EarlyStop already took, without
            # opt_state (a sampling artifact, like the reference's bare
            # state_dict best save, new_scripy.py:836-846)
            payload = {"epoch": epoch, "params": host_state["params"],
                       "batch_stats": host_state["batch_stats"],
                       "loss": float(loss)}
            if host_state.get("ema_params") is not None:
                payload["ema_params"] = host_state["ema_params"]
        else:
            params, batch_stats = host_trees(state.model)
            payload = {"epoch": epoch, "params": params,
                       "batch_stats": batch_stats,
                       "opt_state": opt_state_to_host(state.model,
                                                      state.opt_state),
                       "loss": float(loss)}
            if state.ema is not None:
                payload["ema_params"] = host_trees(state.ema)[0]
        sidecar = None
        if is_best:
            sidecar = (best_sidecar, {"epoch": epoch,
                                      "val_loss": float(loss)})
        path = os.path.join(tc.save_dir, name)
        ckpt_writer.submit(name, path, payload, sidecar=sidecar)
        if verbose:
            print(f"[{time.strftime('%H:%M:%S')}] Queued "
                  f"{'best ' if is_best else ''}checkpoint: {path} "
                  f"(fetch {time.time() - t0:.1f}s)", flush=True)

    train_loss_ema = None
    last_ep = start_epoch - 1  # actual last completed epoch
    last_saved_ep = -1
    try:
        with fp32_compute(dev):
            for ep in range(start_epoch, tc.n_epoch):
                t_ep = time.time()
                prof = None
                if tc.profile_dir and ep == tc.profile_epoch:
                    from torch.profiler import ProfilerActivity, profile

                    acts = [ProfilerActivity.CPU] + (
                        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
                    prof = profile(activities=acts)
                    prof.start()
                losses = []
                nsteps = 0
                t_steps = time.time()
                for batch in train_loader:
                    losses.append(step_fn(state, batch, generator))
                    nsteps += 1
                losses = [float(l) for l in losses]  # sync once per epoch
                if prof is not None:
                    prof.stop()
                    os.makedirs(tc.profile_dir, exist_ok=True)
                    trace = os.path.join(tc.profile_dir, f"trace_ep{ep}.json")
                    prof.export_chrome_trace(trace)
                    if verbose:
                        print(f"Saved profiler trace to {trace}")
                steps_per_sec = nsteps / max(time.time() - t_steps, 1e-9)
                avg_train = float(np.mean(losses)) if losses else float("nan")
                for l in losses:
                    train_loss_ema = l if train_loss_ema is None else (
                        0.95 * train_loss_ema + 0.05 * l)
                metrics_log["train_loss"].append(avg_train)
                metrics_log["steps_per_sec"].append(steps_per_sec)

                # validation
                vlosses = []
                for batch in val_loader:
                    vb = {k: v[0] for k, v in batch.items()}
                    vlosses.append(eval_fn(state, vb, generator))
                val_loss = float(np.mean([float(v) for v in vlosses])) \
                    if vlosses else float("nan")
                metrics_log["val_loss"].append(val_loss)
                # the scheduled LR of this epoch, not the base lr — the
                # reference logs the scheduler's current value
                # (new_scripy.py:913-917)
                metrics_log["lr"].append(float(lr_schedule_fn(
                    ep * steps_per_epoch)))
                if verbose:
                    print(f"[{time.strftime('%H:%M:%S')}] "
                          f"Epoch {ep+1}/{tc.n_epoch} train {avg_train:.4f} "
                          f"val {val_loss:.4f} ({steps_per_sec:.2f} steps/s)",
                          flush=True)

                is_best = early_stop(val_loss, state, ep)
                if early_stop.early_stop:
                    if early_stop.best_state is not None:
                        ckpt_writer.submit(
                            "best_model_early",
                            os.path.join(tc.save_dir, "best_model_early"),
                            early_stop.best_state)
                    break

                # periodic sampling (new_scripy.py:851-893); eval_every=0
                # disables it
                if sampler is not None and tc.eval_every > 0 and (
                        ep % tc.eval_every == 0 or ep == tc.n_epoch - 1):
                    real = np.stack([x for x, _ in eval_samples])
                    # the EMA shadow when kept: that is what it exists for
                    net = state.sampling_model()
                    for w in cfg.sample.guide_scales:
                        t_s = time.time()
                        gen = sampler(net, generator, float(w)).cpu().numpy()
                        imgs_per_min = len(gen) / max(time.time() - t_s,
                                                      1e-9) * 60
                        save_samples(gen, os.path.join(
                            tc.save_dir, f"img_ep{ep}_w{w}.png"), nrow=4,
                            denorm=cfg.sample.denorm)
                        try:
                            qm = img_metrics.evaluate_batch(real, gen)
                            qm.update(guide_scale=w, epoch=ep,
                                      images_per_min=imgs_per_min)
                            metrics_log["img_metrics"].append(qm)
                            if verbose:
                                print(f"  metrics w={w}: " + ", ".join(
                                    f"{k}={v:.4f}" for k, v in qm.items()
                                    if isinstance(v, float)))
                        except Exception as e:
                            print(f"Quality assessment failed: {e}")

                if ((ep + 1) % tc.save_freq == 0 or ep == tc.n_epoch - 1) \
                        and ep >= tc.min_save_ep:
                    save_ckpt(ep, train_loss_ema or 0.0)
                    last_saved_ep = ep
                if is_best:
                    save_ckpt(ep, val_loss, is_best=True,
                              host_state=early_stop.best_state)

                with open(os.path.join(metrics_dir, f"metrics_ep{ep}.json"),
                          "w") as f:
                    json.dump(_sanitize(metrics_log), f, indent=2)
                last_ep = ep
                if verbose:
                    print(f"Epoch time: {time.time() - t_ep:.2f}s")

            # Final save stamped with the ACTUAL last completed epoch (so a
            # later --resume starts at last_ep+1, not n_epoch); skipped when
            # early-stopped (best_model_early holds the state) or when that
            # epoch was already checkpointed in-loop.
            if (not early_stop.early_stop and last_ep >= start_epoch
                    and last_ep != last_saved_ep):
                save_ckpt(last_ep, train_loss_ema or 0.0)
    finally:
        # drain queued writes — also on exceptions, so progress already
        # copied to the host still lands on disk
        if verbose and (ckpt_writer._order or ckpt_writer._pending):
            print("Draining pending checkpoint writes...", flush=True)
        ckpt_writer.close()
        if tc.debug_nans:
            torch.autograd.set_detect_anomaly(False)
    if early_stop.best_state is not None:
        best = early_stop.best_state
        _load_params(state.model, best["params"])
        if best.get("ema_params") is not None and state.ema is not None:
            _load_params(state.ema, best["ema_params"])
        if verbose:
            print(f"Loaded best model (epoch {best['epoch']}), val loss: "
                  f"{best['val_loss']:.6f}")
    return state
