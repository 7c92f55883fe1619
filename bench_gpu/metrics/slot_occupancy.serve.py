"""The batcher's slot occupancy over the window, in %: the slots that held
a requested image over the slots dispatched (``SamplerService.stats``,
``slots_used`` / ``slots_dispatched``, taken as the window's increments)."""


def read(rec):
    st = rec.get("stats")
    if not st or not st.get("slots_dispatched"):
        return None
    return 100.0 * st["slots_used"] / st["slots_dispatched"]
