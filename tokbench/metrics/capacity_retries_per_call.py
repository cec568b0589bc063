"""Layer: the engine's host path (``engine/device.py::_read_metas``). Calls
in the window that ran Stage A again at the roomy capacities because a
chunk's piece or miss table overflowed (each one more metas read), per
call."""


def read(ctx):
    return ctx.delta("capacity_retries") / ctx.calls
