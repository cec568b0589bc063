"""Host time by stage, read from the port's span counters.

The port adds each named span's host time to its engine's int attribute
``<span>_ns`` (``jtokkit_tpu_torch/utils/spans.py``), which
``harness.counters`` takes with the engine's other numbers. The counters
run over the whole window, traced calls or not. A program that keeps no
such counter reads None.
"""


def ms_per_call(ctx, *spans):
    """Host ms a call of the window in the ``spans`` named, summed; None
    where the program lacks the counter of any of them."""
    keys = [f"{s}_ns" for s in spans]
    if any(k not in ctx.before or k not in ctx.after for k in keys):
        return None
    return sum(ctx.delta(k) for k in keys) / ctx.calls / 1e6
