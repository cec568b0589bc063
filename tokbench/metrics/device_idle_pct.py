"""Layer: the device. The share of the traced calls' span (the first
call's issue to the last call's return) in which no kernel, copy or fill
ran on the card, in %."""

from tokbench.trace import idle_pct


def read(ctx):
    return idle_pct(ctx.activity)
