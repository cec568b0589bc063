"""Gather cost on the card against table size, beside searchsorted, a one-hot
select and the shared-memory table kernel.

    python -m jtokkit_tpu_torch.scripts.profile_gather

Counterpart of ``scripts/profile_gather.py``: the same sweep in PyTorch.
2^20 int32 lookups per case:

- ``index_select`` into int32 tables of 256 ... 0x110000 entries,
- the int8 table of 0x110000 entries, with flat and with [8192, 128] indices,
- ``searchsorted`` into 2048 and 256 sorted bounds,
- a one-hot select from a 256-entry table,
- and last the hand-written kernel (:func:`..ops.gather.take_table`) at
  [4096, 128] lookups of a 2048-entry table, with ``index_select`` at the
  same shape beside it.

Every case is timed on the device with CUDA events around back-to-back
calls queued behind a sleep kernel (no host clock, no launch gaps), and its
line names the card and its power limit. The
sweep needs a CUDA card and raises without one.
"""

from __future__ import annotations

import subprocess
from typing import Callable, Dict, List

import numpy as np
import torch

from ..engine.device import resolve_device
from ..ops import gather

N_LOOKUPS = 1 << 20
TABLE_SIZES = (256, 2048, 1 << 14, 1 << 17, 1 << 20, 0x110000)
KERNEL_SHAPE = (4096, 128)
KERNEL_TABLE = 2048


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def event_ms(fn: Callable[[], object], iters: int = 50) -> float:
    """Device milliseconds of one call of ``fn``: CUDA events around
    ``iters`` back-to-back calls, queued behind a sleep kernel so that the
    host's launch time leaves no gaps between them."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # ~25 ms of queue while the host enqueues
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(seed: int = 0) -> List[Dict]:
    """Run the sweep on the card, print one line per case, return the rows."""
    dev = resolve_device(None)
    card = card_line()
    rng = np.random.default_rng(seed)
    rows: List[Dict] = []

    def dev_ints(high, size, dtype=np.int32):
        return torch.from_numpy(rng.integers(0, high, size, dtype=dtype)).to(dev)

    def report(name, fn, n_elems, iters=50):
        ms = event_ms(fn, iters)
        row = {"case": name, "ms": ms, "elems": n_elems,
               "melems_per_s": n_elems / ms / 1e3, "card": card}
        rows.append(row)
        print(f"{name}: {ms:.4f} ms, {row['melems_per_s']:.0f} M elems/s "
              f"[{card}]", flush=True)
        return row

    for size in TABLE_SIZES:
        tbl = dev_ints(100, size)
        idx = dev_ints(size, N_LOOKUPS)
        report(f"index_select int32 tbl={size}",
               lambda: tbl.index_select(0, idx), N_LOOKUPS)

    tbl8 = dev_ints(100, 0x110000, np.int8)
    idx = dev_ints(0x110000, N_LOOKUPS)
    report("index_select int8 tbl=1.1M",
           lambda: tbl8.index_select(0, idx).to(torch.int32), N_LOOKUPS)
    idx2 = idx.reshape(-1, 128).long()
    report("index int8 2D idx", lambda: tbl8[idx2].to(torch.int32), N_LOOKUPS)

    for n_bounds in (2048, 256):
        bounds = torch.from_numpy(
            np.sort(rng.integers(0, 0x110000, n_bounds).astype(np.int32))
        ).to(dev)
        report(f"searchsorted tbl={n_bounds}",
               lambda: torch.searchsorted(bounds, idx, out_int32=True), N_LOOKUPS)

    tbl256 = dev_ints(100, 256)
    idxb = dev_ints(256, N_LOOKUPS)
    lanes = torch.arange(256, dtype=torch.int32, device=dev)[None, :]

    def onehot_select():
        hit = idxb[:, None] == lanes
        return torch.where(hit, tbl256[None, :], 0).sum(dim=1, dtype=torch.int32)

    report("onehot-select tbl=256", onehot_select, N_LOOKUPS, iters=10)

    tblv = dev_ints(100, KERNEL_TABLE)
    idxv = dev_ints(KERNEL_TABLE, KERNEL_SHAPE)
    n_kernel = idxv.numel()
    flat = idxv.reshape(-1)
    report(f"index_select int32 tbl={KERNEL_TABLE} ({n_kernel >> 10}K elems)",
           lambda: tblv.index_select(0, flat), n_kernel, iters=200)
    report(f"take_table shared-memory tbl={KERNEL_TABLE} ({n_kernel >> 10}K elems)",
           lambda: gather.take_table(tblv, idxv), n_kernel, iters=200)
    return rows


if __name__ == "__main__":
    main()
