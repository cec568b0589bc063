"""The peaks and the work the benchmark holds the program to.

The work is counted from what a call must read and write, not from the
kernels that do it, so that replacing a kernel cannot make it stale:
tokenizing reads each UTF-8 byte once and writes each token id once (4
bytes); counting writes one 4-byte count per document. Both are
memory-bound on the card, so the least time is bytes over HBM bandwidth.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: 80 GB of HBM3 at 3.35 TB/s (at the card's
# full 700 W power limit)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}
ID_BYTES = 4


def peak(kind: str, name: str):
    """A peak of the card called ``kind``, or None for a card not in the
    table: no share is ever read against a guessed peak."""
    return PEAKS.get(kind, {}).get(name)


def required_bytes(entry_kind: str, utf8_bytes: int, n_docs: int,
                   n_tokens: int) -> int:
    """Bytes one call must move: its text in, its answer out."""
    if entry_kind == "encode":
        return utf8_bytes + ID_BYTES * n_tokens
    if entry_kind == "count":
        return utf8_bytes + ID_BYTES * n_docs
    raise ValueError(f"no work rule for {entry_kind!r}")


def roofline_pct(ctx):
    """100 x the least time of the traced calls' required bytes at the
    card's HBM bandwidth over the card's busy time in those calls; None
    without a trace, device time or a known peak."""
    a = ctx.activity
    bw = peak(ctx.card, "hbm_bytes_per_s")
    if a is None or a.busy_s <= 0 or bw is None or not ctx.traced_bytes:
        return None
    return 100.0 * ctx.traced_bytes / bw / a.busy_s
