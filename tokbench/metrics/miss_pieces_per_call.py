"""Layer: the kernels (Stage A's miss list, ``ops/stage4.py``, merged in
Stages B-C). Pieces a call sent to the byte-pair merge, per call: the bucket
counts of every chunk routed to Stages B-C, as the engine's ``miss_pieces``
sums them from the metas; None where the program keeps no such counter."""


def read(ctx):
    if "miss_pieces" not in ctx.before or "miss_pieces" not in ctx.after:
        return None
    return ctx.delta("miss_pieces") / ctx.calls
