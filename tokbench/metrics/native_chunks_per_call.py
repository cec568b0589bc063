"""Layer: native routing (``native.py``, ``DeviceEngine._run_host_chunks``).
Chunks the engine sent to the C++ host engine in the window, per call."""


def read(ctx):
    return ctx.delta("native_chunks") / ctx.calls
