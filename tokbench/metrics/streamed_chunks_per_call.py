"""Layer: the engine's host path (``engine/device.py``:
``_stream_stage_a``). Chunks a call whose Stage A went to the card before
the call's last chunk was planned (n - 1 for a call of n chunks); None where
the program keeps no such counter."""


def read(ctx):
    if "streamed_chunks" not in ctx.before or "streamed_chunks" not in ctx.after:
        return None
    return ctx.delta("streamed_chunks") / ctx.calls
