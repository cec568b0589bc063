"""Layer: the device. Host ms a call that the host sat blocked on the card:
the ``metas_read``, ``counts_read`` and ``fetch_wait`` spans, summed (the
host's counterpart of ``device_idle_pct``)."""

from tokbench.spans import ms_per_call


def read(ctx):
    return ms_per_call(ctx, "metas_read", "counts_read", "fetch_wait")
