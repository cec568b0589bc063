"""Layer: the kernels (Stage A's ``"unicode"`` variant, ``ops/stage4.py``
and ``ops/classify.py``: the byte classes of every script). Chunks a call
staged at that variant, those with a non-ASCII byte, as the engine's
``unicode_chunks`` counts them; None where the program keeps no such
counter. It counts the traffic's shape: only a change of traffic or of the
chunk packer moves it."""


def read(ctx):
    if "unicode_chunks" not in ctx.before or "unicode_chunks" not in ctx.after:
        return None
    return ctx.delta("unicode_chunks") / ctx.calls
