"""Layer: native routing (``native.py``, ``DeviceEngine._run_host_chunks``).
Host ms a call in the ``host_chunks`` span: the chunks that left the device
path (native and fallback), with the wait on the native engine's threads
inside."""

from tokbench.spans import ms_per_call


def read(ctx):
    return ms_per_call(ctx, "host_chunks")
