"""Layer: the engine's host path (``engine/device.py``: ``preload_corpus``,
``_plan_chunks``). Host ms a call in the ``plan`` span: the batch's UTF-8
encode, safe splits, packing into chunks and each chunk's ASCII test."""

from tokbench.spans import ms_per_call


def read(ctx):
    return ms_per_call(ctx, "plan")
