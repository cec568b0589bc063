"""Layer: the facade (``encoding_impl.py``: ``count_tokens_batch``). Host ms a
call in the ``special_check`` span: the special-token check of every
document before the engine's count."""

from tokbench.spans import ms_per_call


def read(ctx):
    return ms_per_call(ctx, "special_check")
