"""The device memory peak of the window's training steps, in GiB
(``torch.cuda.max_memory_allocated`` after a reset at the window's
opening)."""


def read(rec):
    b = rec.get("peak_bytes_window")
    return None if not b else b / 2 ** 30
