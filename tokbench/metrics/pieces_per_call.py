"""Layer: the kernels (Stage A's piece table, ``ops/stage4.py``, read by
Stages B-C). Pieces a call's pre-split gave: the metas' ``n_pieces`` of
every chunk routed to Stages B-C, as the engine's ``pieces`` sums them;
None where the program keeps no such counter. Beside
``miss_pieces_per_call`` it gives the share of pieces the merge takes."""


def read(ctx):
    if "pieces" not in ctx.before or "pieces" not in ctx.after:
        return None
    return ctx.delta("pieces") / ctx.calls
