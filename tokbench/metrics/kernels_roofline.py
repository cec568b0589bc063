"""Layer: the kernels (``ops/*``, ``csrc/*``). The least time the traced
calls' work needs at the card's HBM bandwidth (each UTF-8 byte read once,
each id or count written once: ``yardstick.required_bytes``) over the
card's busy time in the same calls, in %."""

from tokbench.yardstick import roofline_pct


def read(ctx):
    return roofline_pct(ctx)
