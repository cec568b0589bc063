"""Layer: the engine's host path (``engine/device.py``:
``encode_ordinary_batch_arrays``, ``_consume_fetch``). Host ms a call in
the ``unpack_split`` span: the fetched ids unpacked, split by document and
joined."""

from tokbench.spans import ms_per_call


def read(ctx):
    return ms_per_call(ctx, "unpack_split")
