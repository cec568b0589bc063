"""Layer: the kernels (Stage A, ``ops/stage4.py``, run again at the roomy
capacities by ``engine/device.py::_read_metas``). Host ms a call in the
``capacity_retry`` span: the re-issue of the chunks whose tables overflowed
and the blocking read of their metas, which holds the card's time; None
where the program keeps no such span."""

from tokbench.spans import ms_per_call


def read(ctx):
    return ms_per_call(ctx, "capacity_retry")
