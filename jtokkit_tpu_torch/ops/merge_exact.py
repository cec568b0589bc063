"""Wide-bucket hybrid merge: batched byte round + compacting sequential.

Counterpart of ``jtokkit_tpu/ops/merge_exact.py``. Long regex pieces (CJK
letter runs, punctuation runs) make the plain sequential-step merge
quadratic-ish: rounds ~ piece bytes, each round touching the full [W, cap]
matrix. This engine cuts both factors while staying bit-exact with the
reference merge loop (``M/GptBytePairEncoding.java:200-275``):

1. **Batched byte round** (:func:`round1_bytes`): every byte pair whose rank
   provably precedes all possible competitors merges at once. Safety rides
   the ``byte_pair_seed`` table's precomputed threat bits
   (``vocab/tables.py``); equal-rank runs (whitespace, repeated characters)
   merge pairwise by chain parity with a prefix-AND guard, exactly the
   sequential outcome.
2. **Sequential rounds with width-halving compaction**: the remaining merges
   run the one-merge-per-piece-per-round step (:func:`.merge.t3_round`, the
   narrow engine's). After the batched round the per-piece span counts fit
   half the width, so the state compacts [W] -> [W/2] -> ... -> [32]
   (:func:`_compact`, a stable per-column partition), and late rounds touch a
   fraction of the matrix. A phase ends when every column fits the next
   width or nothing is left to merge, so compaction never drops a live span.

The phase loops have the three forms of :func:`.merge.run_rounds`: cold,
one flag read back per round; with ``rounds=`` (the per-phase counts a cold
pass over the same bytes reported), exactly those rounds and nothing read
back; with ``rounds=DEVICE``, each phase a loop tested on the device with
its own stop test and its own round counter. Fewer rounds than the cold pass
ran would let :func:`_compact` drop a live span, so cached counts are used
as they are, and the device form's counters equal the cold form's counts.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from . import colscan, merge, pipeline
from .classify import take_clip

MAX_RANK = merge.MAX_RANK


def _shift_down(x, fill):
    """Row w takes row w - 1; row 0 takes ``fill``."""
    return torch.cat([x.new_full((1, x.shape[1]), fill), x[:-1]], dim=0)


def _shift_up(x, fill):
    return torch.cat([x[1:], x.new_full((1, x.shape[1]), fill)], dim=0)


def round1_bytes(mat_t, col_len, byte_to_id, byte_pair_seed):
    """Byte-level first round: seed ranks and safety bits in one gather,
    adjacent-row neighbours, equal-rank chain parity.

    Returns (ids, active, progress 0-d bool, counts int32[R]).
    """
    W, _R = mat_t.shape
    subl = torch.arange(W, dtype=torch.int32, device=mat_t.device)[:, None]
    b = mat_t.to(torch.int32)
    active = subl < col_len[None, :]
    ids = torch.where(active, take_clip(byte_to_id, b), -1)

    b_next = _shift_up(b, 0)
    is_pair = subl + 1 < col_len[None, :]
    seed = take_clip(byte_pair_seed, b * 256 + b_next)
    rank = torch.where(is_pair & (seed >= 0), seed & 0x3FFFF, MAX_RANK)
    s_l = (seed >> 18) & 1
    s_r = (seed >> 19) & 1

    r_prv = _shift_down(rank, MAX_RANK)
    r_nxt = _shift_up(rank, MAX_RANK)
    valid = rank < MAX_RANK
    l1 = (subl == 0) | (r_prv > rank)
    l2 = (subl <= 1) | (s_l == 1)
    r1 = r_nxt >= rank
    r2 = (subl + 2 >= col_len[None, :]) | (s_r == 1)
    base = valid & l2 & r1 & r2

    # equal-rank chains: heads are every position that does not continue a
    # run (invalid positions are their own heads, so propagation never
    # crosses pieces or gaps)
    eq_l = (subl > 0) & (r_prv == rank) & valid
    (head_pos,) = colscan.col_scan([torch.where(~eq_l, subl, -1)], ["last"])
    even = ((subl - head_pos) % 2) == 0

    (fail_incl,) = colscan.col_scan([(even & ~base).to(torch.int32)], ["add"])
    fail_excl = _shift_down(fail_incl, 0)
    # propagate (fails before the head, the head's l1) from each head
    ref_leaf = torch.where(~eq_l, fail_excl * 2 + l1.to(torch.int32), -1)
    (ref,) = colscan.col_scan([ref_leaf], ["last"])

    do = base & even & ((ref & 1) == 1) & ((ref >> 1) == fail_excl)

    # forced sequential step: keeps `progress == False` equivalent to `no
    # mergeable pair anywhere`
    col_any = do.any(dim=0)
    minval = rank.amin(dim=0)
    m = torch.argmin(rank, dim=0).to(torch.int32)
    force = ~col_any & (minval < MAX_RANK)
    do = do | (force[None, :] & (subl == m[None, :]))

    consumed = active & _shift_down(do, False)
    new_ids = torch.where(do, rank, ids)
    new_active = active & ~consumed
    counts = new_active.sum(dim=0, dtype=torch.int32)
    return new_ids, new_active, do.any(), counts


def _compact(ids, rank, active, w_new: int):
    """Stable per-column partition of live spans into the top ``w_new``
    rows, carrying (ids, rank). Adjacency among live spans is preserved, so
    carried pair ranks stay valid. Callers guarantee every column's live
    count <= w_new (the phase's exit condition).

    Keys are unique per column (row, or row + W where dead), so the order is
    the same under any sort; ids and rank follow the keys' permutation.
    """
    W, _R = ids.shape
    dev = ids.device
    subl = torch.arange(W, dtype=torch.int32, device=dev)[:, None]
    key = torch.where(active, subl, subl + W)
    order = torch.sort(key, dim=0).indices[:w_new]
    counts = active.sum(dim=0, dtype=torch.int32)
    sub2 = torch.arange(w_new, dtype=torch.int32, device=dev)[:, None]
    active2 = sub2 < counts[None, :]
    rank2 = torch.where(active2, rank.gather(0, order), MAX_RANK)
    return ids.gather(0, order), rank2, active2


def phase_chain(lanes: int) -> Tuple[int, ...]:
    """Compaction width schedule for a bucket of the given lane width."""
    chain = [lanes]
    w = lanes
    while w > 32:
        w = max(w // 2, 32)
        chain.append(w)
    return tuple(chain)


def merge_bucket_exact(
    buf, starts, lens, miss_sorted, group_start_b, count_b,
    byte_to_id, byte_pair_seed, pair_rows_cat, table_mask,
    *, lanes: int, cap: int, rounds=None,
):
    """Merge one wide bucket's pieces with the hybrid engine.

    ``rounds``: None for the cold form, the rounds to run in each phase
    (what a cold call on the same bytes returned), or ``merge.DEVICE``.
    ``group_start_b`` and ``count_b`` may be ints or 0-d device tensors.

    Returns (cols int32[cap] piece indices, outs, rounds run per phase: ints,
    or 0-d int32 tensors for ``DEVICE``)
    where outs is a list of (ids int32[W_k, cap], active bool[W_k, cap])
    per phase; each piece's surviving spans appear in exactly one phase
    output, in byte order.
    """
    cols, live, c_len, mat_t = pipeline.bucket_matrix(
        buf, starts, lens, miss_sorted, group_start_b, count_b,
        lanes=lanes, cap=cap,
    )
    ids, active, _progress, _counts = round1_bytes(
        mat_t, c_len, byte_to_id, byte_pair_seed
    )
    rank = merge.rank_from_state(ids, active, pair_rows_cat, table_mask)

    chain = phase_chain(lanes)
    device = rounds == merge.DEVICE
    if rounds is not None and not device and len(rounds) != len(chain):
        raise ValueError(f"{len(chain)} phases, {len(rounds)} round counts")
    outs: List[Tuple[torch.Tensor, torch.Tensor]] = []
    ran = []
    for k, w in enumerate(chain):
        last = k + 1 == len(chain)
        if k > 0:
            ids, rank, active = _compact(ids, rank, active, w)
        if last:
            more = None  # while a mergeable pair is left
        else:
            def more(rank, active, _wn=chain[k + 1]):
                return (rank.amin() < MAX_RANK) & (
                    active.sum(dim=0, dtype=torch.int32).amax() > _wn
                )
        ids, rank, active, n = merge.run_rounds(
            ids, rank, active, pair_rows_cat, table_mask,
            rounds if rounds is None or device else rounds[k], more,
        )
        ran.append(n)
        # emit everything once the run is globally done (no mergeable pair
        # anywhere); the final phase emits the remainder
        emit = torch.ones_like(live[0]) if last else ~(rank.amin() < MAX_RANK)
        outs.append((ids, active & emit & live[None, :]))
        active = active & ~emit
    return cols, outs, tuple(ran)
