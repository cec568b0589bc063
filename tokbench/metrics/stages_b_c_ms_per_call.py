"""Layer: the kernels (the merges and Stage C: ``ops/pipeline.py``,
``ops/loop.py``; issued by ``engine/device.py::_run_stages_b_c``). Host ms
a call in the ``stages_b_c`` span (routing and every chunk's Stages B-C
issued) and the ``counts_read`` span (the blocking read of the token and
document counts, which holds the card's time), summed."""

from tokbench.spans import ms_per_call


def read(ctx):
    return ms_per_call(ctx, "stages_b_c", "counts_read")
