"""Set-up seconds (host clock): building the program and its weights,
the kernels' build on a checkout's first run, and the warm-up of the
cell's shapes, up to the window."""


def read(rec):
    return rec.get("setup_s")
