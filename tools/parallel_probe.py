#!/usr/bin/env python3
"""The ``parallel`` phase of ``chip_smoke.py`` alone, on one card:

    python3 tools/parallel_probe.py [--out FILE]

(world size 1 over NCCL: the mesh train step, the mesh sampler and
``SamplerService(mesh=)`` against their plain forms, on the bf16
flagship; its first step pays cuDNN's search). Every line also goes to
``--out``."""

import argparse
import contextlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import chip_smoke as c
    from diffusionmodel_tpu_torch.config import preset
    from diffusionmodel_tpu_torch.kernels import _build
    from diffusionmodel_tpu_torch.kernels.coord_attn import coord_attn
    from diffusionmodel_tpu_torch.kernels.se_block import se_block

    out = open(args.out, "w") if args.out else None

    class Tee:
        def write(self, s):
            sys.__stdout__.write(s)
            if out:
                out.write(s)
                out.flush()

        def flush(self):
            sys.__stdout__.flush()

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with contextlib.redirect_stdout(Tee()):
        c.phase_env()
        _build.build()
        mc = preset("full").diffusion
        dataset = c._synthetic_crack_dataset(
            256, (mc.low_weight, mc.mid_weight, mc.high_weight))
        c.timed("parallel", c.phase_parallel, [se_block, coord_attn],
                os.path.join(here, "output", "parallel_probe"), dataset)
    return 0


if __name__ == "__main__":
    sys.exit(main())
