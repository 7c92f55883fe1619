"""On the card, at each cell's own size: the program passes its limits and
each control (the reference computed below the configuration's
precision, in the program's place) and each planted fault fails at least
one of them. Skips without a card:

    python -m pytest bench_gpu/tests/test_bench_cuda.py -m cuda
"""

import pytest

from bench_gpu import calibrate, harness

CELLS = [w["name"] for w in harness.load_spec()["workloads"]]
SEED = 2 ** 33 + 101


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_controls_fail_and_the_program_passes(cuda, name):
    harness.prepare_env()
    cell = harness.find_cell(harness.load_spec(), name, False)
    r = calibrate.readings(cell, SEED, 20.0, cuda)
    assert r["correct"], r["checks"]
    verdicts = list(r.get("control_verdict", {}).items()) \
        + list(r.get("fault_verdict", {}).items())
    assert verdicts
    for what, v in verdicts:
        assert not v["correct"], (what, v["checks"])
