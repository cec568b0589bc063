"""Layer: the engine's host path (``engine/device.py``: ``_pack_fetch``,
``_copy_fetch``, ``_wait_fetches``). Host ms a call in the ``fetch`` span
(each chunk's token pack issued and copied to pinned memory without
blocking) and the ``fetch_wait`` span (the one wait on those copies),
summed."""

from tokbench.spans import ms_per_call


def read(ctx):
    return ms_per_call(ctx, "fetch", "fetch_wait")
