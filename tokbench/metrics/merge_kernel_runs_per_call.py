"""Layer: the kernels (the merge kernel of Stage B, ``csrc/merge.cu`` through
``ops/merge.py``). Bucket merges the kernel ran in the window, per call, as
the engine's ``merge_kernel_runs`` counts them (one a launch; a graph replay
adds the launches its capture holds); None where the program keeps no such
counter."""


def read(ctx):
    if "merge_kernel_runs" not in ctx.before or "merge_kernel_runs" not in ctx.after:
        return None
    return ctx.delta("merge_kernel_runs") / ctx.calls
