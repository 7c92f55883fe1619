"""Training images consumed by optimizer steps over the whole window (host
clock): every step started inside the window, over the time until the
last of them finished."""


def read(rec):
    if not rec.get("trained_images"):
        return None
    return rec["trained_images"] / rec["window_s"]
