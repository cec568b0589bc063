"""Layer: the un-planned path's graph cache (``engine/device.py``:
``_cold_run``, ``cold_cache_stats``; ``ops/loop.py``). Graphs captured in
the window, after the warm-up has run every batch of the ring once: a
shape pushed out of the cache (``COLD_CACHE_MAX`` a kind) and captured
again stalls its call."""


def read(ctx):
    return ctx.delta("cold.captures")
