"""Layer: the engine's host path (``engine/device.py``: ``_process_chunks``,
``_read``, ``_wait_fetches``). The engine's ``host_reads`` over the window
per call."""


def read(ctx):
    return ctx.delta("host_reads") / ctx.calls
