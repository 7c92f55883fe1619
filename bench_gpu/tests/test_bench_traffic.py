"""The traffic generators repeat exactly per seed, also for seeds past 32
bits, and differ between seeds and clients."""

import itertools
import json

import numpy as np

from bench_gpu import harness, traffic

SEEDS = (7, 2 ** 31 + 3, 2 ** 40 + 11)


def _serve_mix():
    return json.loads((harness.HERE / "workloads" /
                       "ctxunet-serve-dpmpp20.json").read_text())


def _take(tr, seed, client, n=64):
    return list(itertools.islice(traffic.serve_requests(tr, seed, client), n))


def test_serve_requests_repeat_per_seed():
    tr = _serve_mix()
    for seed in SEEDS:
        assert _take(tr, seed, 0) == _take(tr, seed, 0)
        assert _take(tr, seed, 0) != _take(tr, seed, 1)
    assert _take(tr, SEEDS[0], 0) != _take(tr, SEEDS[1], 0)


def test_serve_requests_follow_the_mix():
    tr = _serve_mix()
    reqs = [r for c in range(tr["clients"]) for r in _take(tr, SEEDS[1], c,
                                                           400)]
    assert {len(r["classes"]) for r in reqs} <= set(tr["images_per_request"])
    assert {c for r in reqs for c in r["classes"]} == set(range(tr["classes"]))
    assert {r["guide_w"] for r in reqs} == set(tr["guide_w"])
    pinned = np.mean([r["seed"] is not None for r in reqs])
    assert abs(pinned - tr["pinned_share"]) < 0.05
    seeds = [r["seed"] for r in reqs if r["seed"] is not None]
    assert len(set(seeds)) == len(seeds)


def test_crack_batches_repeat_per_seed():
    cfg = {"model": {"img_size": 32, "in_ch": 3, "n_classes": 5}}
    tr = {"accum_steps": 2, "micro_batch": 3}
    a = traffic.crack_batches(tr, cfg, SEEDS[2], 4)
    b = traffic.crack_batches(tr, cfg, SEEDS[2], 4)
    c = traffic.crack_batches(tr, cfg, SEEDS[0], 4)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(a["x"], c["x"])
    assert a["x"].shape == (4, 2, 3, 32, 32, 3) and a["x"].dtype == np.uint8
    assert a["mask"].shape == (4, 2, 3, 32, 32)
    assert set(np.unique(a["mask"])) == {0, 1, 2}
    # every image of the pool differs from every other
    flat = a["x"].reshape(24, -1)
    assert len({row.tobytes() for row in flat}) == 24
