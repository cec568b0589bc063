"""Layer: the engine's host path (``engine/device.py::_read_metas``). Chunks
a call ran through Stage A again at the roomy capacities because their
piece or miss table overflowed, as the engine's ``retried_chunks`` counts
them (``capacity_retries`` counts the calls); None where the program keeps
no such counter."""


def read(ctx):
    if "retried_chunks" not in ctx.before or "retried_chunks" not in ctx.after:
        return None
    return ctx.delta("retried_chunks") / ctx.calls
