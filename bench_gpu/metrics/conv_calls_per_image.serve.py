"""Per-sample convolution calls per image returned over the window: the
increment of the program's ``conv.per_sample_calls`` counter (a bf16
convolution without gradients adds its batch size once per call that it
splits into one call per sample) over the images returned."""

from bench_gpu.spans import program


def read(rec):
    p = program(rec)
    if not p or not rec.get("images"):
        return None
    calls = p["counters"].get("conv.per_sample_calls")
    return None if calls is None else calls / rec["images"]
