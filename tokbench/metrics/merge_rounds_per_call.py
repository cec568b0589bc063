"""Layer: the kernels (the byte-pair merge loops of Stages B-C:
``ops/merge.py``, ``ops/loop.py``, ``csrc/loop.cu``). Rounds the merge loops
ran in the window, per call, as the engine's ``merge_rounds`` counts them
(read back with each call's last read); None where the program keeps no such
counter."""


def read(ctx):
    if "merge_rounds" not in ctx.before or "merge_rounds" not in ctx.after:
        return None
    return ctx.delta("merge_rounds") / ctx.calls
