"""Seconds per batch of the service's worker over the window
(``SamplerService.stats``: ``busy_seconds`` / ``batches``; each batch ends
in a copy to the host, which waits for the device)."""


def read(rec):
    st = rec.get("stats")
    if not st or not st.get("batches"):
        return None
    return st["busy_seconds"] / st["batches"]
