"""The port's SamplerService and HTTP front end (CPU, tiny model).

The JAX package's service and the port's serve the same bridged weights:
a seed-pinned request starts from the same numpy x_T in both, so under
the deterministic samplers their images agree to the sampler tolerance
of tests/test_torch_sampling.py (rtol 5e-3 / atol 5e-4). Inside the port,
a pinned request's images are bit-identical whatever shares its batch.
"""

import base64
import json
import struct
import threading
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusionmodel_tpu.config import preset as jax_preset
from diffusionmodel_tpu.diffusion import Schedule as JSchedule
from diffusionmodel_tpu.nn import build_model as jax_build_model
from diffusionmodel_tpu.serving import SamplerService as JSamplerService
from diffusionmodel_tpu_torch.compat.flax_bridge import state_dict_from_flax
from diffusionmodel_tpu_torch.config import preset
from diffusionmodel_tpu_torch.diffusion import Schedule
from diffusionmodel_tpu_torch.nn import build_model
from diffusionmodel_tpu_torch.serving import SamplerService, make_http_server

torch.set_num_threads(2)

TINY = {"model.n_feat": 8, "model.img_size": 32, "model.n_classes": 3,
        "diffusion.n_T": 10, "sample.ddim_steps": 4, "sample.dpm_steps": 4}


@pytest.fixture(scope="module")
def tiny():
    """(cfg, port model, port schedule, JAX model, JAX params): JAX init,
    carried into the port by the bridge."""
    cfg = preset("full", **TINY)
    jcfg = jax_preset("full", **TINY)
    jm = jax_build_model(jcfg.model, jcfg.diffusion.high_thresh)
    v = jax.jit(jm.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), jnp.zeros((2, 32, 32, 3)),
        jnp.zeros((2,), jnp.int32), jnp.full((2,), 0.5), jnp.ones((2,)),
        attn_mask=None, train=False)
    params = jax.tree.map(np.asarray, v["params"])
    model = build_model(cfg.model, cfg.diffusion.high_thresh, device="cpu")
    model.load_state_dict(state_dict_from_flax(params))
    dc = cfg.diffusion
    return (cfg, model, Schedule.create(dc.beta1, dc.beta2, dc.n_T, "cpu"),
            jm, params)


@pytest.mark.parametrize("kind", ["ddim", "dpmpp"])
def test_pinned_request_matches_jax_service(tiny, kind):
    cfg, model, sched, jm, params = tiny
    dc = cfg.diffusion
    jsched = JSchedule.create(dc.beta1, dc.beta2, dc.n_T)
    with JSamplerService(jm, cfg, jsched, params, max_batch=4,
                         sampler=kind) as jsvc:
        want = jsvc.generate([0, 2, 1], guide_w=2.0, seed=11)
    with SamplerService(model, cfg, sched, max_batch=4, sampler=kind) as svc:
        got = svc.generate([0, 2, 1], guide_w=2.0, seed=11)
    assert got.shape == (3, 32, 32, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-4)


@pytest.mark.parametrize("kind", ["ddim", "ancestral"])
def test_pinned_request_is_batch_independent(tiny, kind):
    """Deterministic (ddim) and stochastic (ancestral: per-slot noise
    streams) samplers: a pinned request reproduces its run-alone images
    bit for bit when it shares a batch with other traffic."""
    cfg, model, sched, _, _ = tiny
    with SamplerService(model, cfg, sched, max_batch=4, sampler=kind,
                        max_wait_ms=1000.0) as svc:
        assert svc._deterministic == (kind == "ddim")
        alone = svc.generate([0, 1], guide_w=2.0, seed=7)
        st0 = dict(svc.stats)
        f1 = svc.submit([2], guide_w=5.0)
        f2 = svc.submit([0, 1], guide_w=2.0, seed=7)
        f3 = svc.submit([1], guide_w=0.0, seed=9)
        other, shared, third = f1.result(60), f2.result(60), f3.result(60)
        st1 = dict(svc.stats)
    np.testing.assert_array_equal(shared, alone)
    assert st1["batches"] - st0["batches"] == 1
    assert st1["pinned_batches"] - st0["pinned_batches"] == 1
    assert other.shape == (1, 32, 32, 3) and third.shape == (1, 32, 32, 3)
    assert np.isfinite(np.concatenate([other, shared, third])).all()


def test_submit_validation_and_close(tiny):
    cfg, model, sched, _, _ = tiny
    with SamplerService(model, cfg, sched, max_batch=4,
                        sampler="ddim") as svc:
        for bad in ([0] * 5, [], [3], [-1], [[0, 1]]):
            with pytest.raises(ValueError):
                svc.submit(bad)
        for seed in ("x", 1.5):
            with pytest.raises(ValueError):
                svc.submit([0], seed=seed)
        a = svc.generate([0], guide_w=2.0, seed=-1)
        b = svc.generate([0], guide_w=2.0, seed=2 ** 63 - 1)
        c = svc.generate([0], guide_w=2.0, seed=7.0)  # integral JSON float
        np.testing.assert_array_equal(a, b)  # -1 maps to 2**63 - 1
        assert c.shape == (1, 32, 32, 3)
    with pytest.raises(RuntimeError):
        svc.submit([0])
    with pytest.raises(ValueError, match="sampler"):
        SamplerService(model, cfg, sched, sampler="euler")


def _decode_png(data: bytes) -> np.ndarray:
    """Decode the service's 8-bit RGB PNG (filter 0 rows) with zlib."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, size = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        assert zlib.crc32(kind + body) & 0xFFFFFFFF == struct.unpack(
            ">I", data[pos + 8 + n:pos + 12 + n])[0]
        if kind == b"IHDR":
            size = struct.unpack(">II", body[:8])
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h = size
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * 3)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, 3)


def test_http_round_trip(tiny):
    cfg, model, sched, _, _ = tiny
    svc = SamplerService(model, cfg, sched, max_batch=4, sampler="ddim")
    httpd = make_http_server(svc, host="127.0.0.1", port=0,
                             class_names=["a", "b", "c"])
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{port}"
    try:
        body = json.dumps({"classes": ["b", 2], "guide_w": 2.0,
                           "seed": 5}).encode()
        req = urllib.request.Request(f"{url}/generate", data=body,
                                     headers={"Content-Type":
                                              "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
        imgs = [_decode_png(base64.b64decode(s)) for s in out["images"]]
        direct = svc.generate([1, 2], guide_w=2.0, seed=5)
        want = np.clip((direct * 0.5 + 0.5) * 255.0, 0, 255).astype(np.uint8)
        np.testing.assert_array_equal(np.stack(imgs), want)

        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
            h = json.loads(r.read())
        assert h["status"] == "ok" and h["classes"] == ["a", "b", "c"]
        assert h["stats"]["images"] == 4 and 0 < h["slot_occupancy"] <= 1
        for bad in ([7], ["zebra"]):
            req = urllib.request.Request(
                f"{url}/generate", data=json.dumps({"classes": bad}).encode())
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=30)
            assert e.value.code == 400
    finally:
        httpd.shutdown()
        httpd.server_close()
        svc.close()
    thread.join(timeout=30)
    assert not thread.is_alive()
