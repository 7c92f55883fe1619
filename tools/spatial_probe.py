#!/usr/bin/env python3
"""The spatial and model-axis phases of ``chip_smoke.py`` alone, on one
card:

    python3 tools/spatial_probe.py [--kernels] [--ranks] [--out FILE]

``--kernels`` runs ``spatial_kernels`` (the SE and CoordAttn slab forms
against the whole-map kernels and the twins at every flagship site, fp32
and bf16, 2 and 4 slabs, with one process's share timed); ``--ranks``
runs ``spatial`` (two processes on the card over gloo, on a data 1 x
spatial 2 mesh and then a data 1 x model 2 mesh) and ``mesh_reference``
(both against one process). Both when neither is given. Every line also
goes to ``--out``, where a long output can be read whole."""

import argparse
import contextlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--ranks", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    both = not (args.kernels or args.ranks)
    import chip_smoke as c
    from diffusionmodel_tpu_torch.kernels import _build

    out = open(args.out, "w") if args.out else None

    class Tee:
        def write(self, s):
            sys.__stdout__.write(s)
            if out:
                out.write(s)
                out.flush()

        def flush(self):
            sys.__stdout__.flush()

    with contextlib.redirect_stdout(Tee()):
        c.phase_env()
        report = _build.build()
        for name in ("se_block", "coord_attn"):
            print(report[name]["log"][-3000:])
        if args.kernels or both:
            c.timed("spatial_kernels", c.phase_spatial_kernels)
        if args.ranks or both:
            here = os.path.dirname(os.path.dirname(os.path.abspath(
                __file__)))
            runs = c.timed("spatial", c.phase_spatial,
                    os.path.join(here, "chiprun_out", "spatial_probe"))
            c.timed("mesh_reference", c.phase_mesh_reference, runs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
