"""Layer: the kernels (Stage A: ``ops/stage4.py``, ``csrc/scan.cu``; issued by
``engine/device.py::_run_stage_a``). Host ms a call in the ``stage_a``
span: every chunk's Stage A issued (graph replays from the cache), the
capacity retry, and the blocking read of the metas, which holds the card's
time."""

from tokbench.spans import ms_per_call


def read(ctx):
    return ms_per_call(ctx, "stage_a")
