"""Images generated and returned over the whole window (host clock): every
image of every request that returned, over the time from the window's
opening to the return of the last request sent inside it."""


def read(rec):
    if not rec.get("images"):
        return None
    return rec["images"] / rec["window_s"]
