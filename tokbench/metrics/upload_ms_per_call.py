"""Layer: the engine's host path (``engine/device.py``: ``preload_corpus``).
Host ms a call in the ``upload`` span: each chunk's bytes and document ends
copied to the card."""

from tokbench.spans import ms_per_call


def read(ctx):
    return ms_per_call(ctx, "upload")
