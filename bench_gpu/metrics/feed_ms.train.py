"""Host ms per optimizer step spent feeding its micro-batches to the device
over the window: the program's ``train.feed`` spans (the copy of a
micro-batch to the device and its wire decode, including any wait on the
stream that the copy makes) summed, over the window's ``train.step``
spans."""

from bench_gpu.spans import program


def read(rec):
    p = program(rec)
    if not p:
        return None
    d = p["durations"]
    if not d.get("train.step") or not d.get("train.feed"):
        return None
    return 1e3 * sum(d["train.feed"]) / len(d["train.step"])
