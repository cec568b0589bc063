"""Per-column prefix scans over [W, R] matrices (independent columns).

Counterpart of ``jtokkit_tpu/ops/colscan.py``, used by the wide-bucket
hybrid merge's batched byte round (:mod:`.merge_exact`). The reference is a
plain ``lax.associative_scan`` along axis 0 (it has no kernel of its own),
and this is ``torch.cummax`` / ``torch.cumsum`` along dim 0.

Combine kinds (as in :mod:`.scan`):

- ``last`` -- latest value >= 0 in scan order wins (identity -1)
- ``max``  -- running maximum
- ``add``  -- running sum (identity 0)

``reverse=True`` scans bottom-up (suffix scan within the column).
"""

from __future__ import annotations

import torch


def _ident(kind: str) -> int:
    return 0 if kind == "add" else -1


def _scan_one(x, kind: str):
    if kind == "max":
        return torch.cummax(x, 0).values
    if kind == "add":
        return torch.cumsum(x, 0, dtype=torch.int32)
    if kind != "last":
        raise ValueError(kind)
    # the row of the latest value >= 0, by a running maximum of row indices
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    src = torch.cummax(torch.where(x >= 0, rows, -1), 0).values
    return torch.where(src >= 0, x.gather(0, src.clamp_min(0)), -1)


def col_scan(leaves, kinds, *, reverse: bool = False):
    """Inclusive per-column scan of each int32[W, R] leaf."""
    out = []
    for x, kind in zip(leaves, kinds):
        x = x.to(torch.int32)
        if reverse:
            out.append(_scan_one(x.flip(0), kind).flip(0))
        else:
            out.append(_scan_one(x, kind))
    return out


def excl_fwd(leaves, kinds):
    """Exclusive forward scan: value aggregated over rows strictly above."""
    out = []
    for x, kind in zip(col_scan(leaves, kinds), kinds):
        fill = x.new_full((1, x.shape[1]), _ident(kind))
        out.append(torch.cat([fill, x[:-1]], dim=0))
    return out


def excl_rev(leaves, kinds):
    """Exclusive reverse scan: value aggregated over rows strictly below."""
    out = []
    for x, kind in zip(col_scan(leaves, kinds, reverse=True), kinds):
        fill = x.new_full((1, x.shape[1]), _ident(kind))
        out.append(torch.cat([x[1:], fill], dim=0))
    return out
