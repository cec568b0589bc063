"""Device byte-pair merge, vectorized across pieces.

Counterpart of ``jtokkit_tpu/ops/merge.py`` (``pair_lookup_cat``,
``t3_round``, ``rank_from_state``, ``merge_rows_t3``, and the row-major
``merge_rows`` of the long-piece fallback). In Stage B pieces are columns of a [W, R] matrix
(W = bucket width, R = pieces) and the sequential min-rank merge of the
reference runs one step per column per round:

  1. argmin of the pair ranks down each column (leftmost minimum wins, the
     reference's strict ``<`` scan; ``torch.argmin`` returns the first
     minimal index),
  2. the pair merges: the left span takes the merged id (rank == id in
     tiktoken vocabularies), the right span goes inactive,
  3. the two affected neighbour ranks are looked up again, both sites and
     both cuckoo probes in one batched row gather.

The loop ends when no column has a mergeable pair. It has three forms. The
cold form (``rounds=None``) tests for that after every round and so reads
one flag back to the host per round. The fixed-count form (``rounds=k``)
runs exactly ``k`` rounds and reads nothing back: a round with nothing to
merge changes nothing (:func:`t3_round` masks every update by ``minval <
MAX_RANK``), and the rounds a bucket needs depend only on its bytes, so a
count taken from a cold pass over the same bytes is exact. The device form
(``rounds=DEVICE``, the counterpart of the reference's ``lax.while_loop``)
tests on the device: on CUDA it is recorded into the CUDA graph being
captured as one conditional WHILE node (:func:`.loop.while_loop`), and the
rounds it ran come back as a 0-d int32 tensor; its plain version, on the
CPU, is the cold loop. :data:`MERGE_ROUNDS` counts the rounds of the cold
and fixed forms where they run; the device form's rounds are added by
whoever reads its counter back. :data:`EXIT_TESTS` counts the flags read
back.
"""

from __future__ import annotations

import torch

from . import loop
from .classify import take_clip
from .colscan import excl_rev
from .stage4 import _mix

MAX_RANK = 0x7FFFFFFF
# the device loop form of run_rounds, merge_rows_t3 and merge_rows
DEVICE = "device"

_H1 = (0x9E3779B1, 0x85EBCA77, 0x2C1B3C6D)
_H2 = (0xC2B2AE3D, 0x27D4EB2F, 0x165667B1)

# merge rounds run by merge_rows_t3 and merge_rows since the counter was last
# reset (the device form's are added where its counter is read back)
MERGE_ROUNDS = 0
# exit tests of the cold loops: each is one 0-d bool read back to the host,
# counted where it is read
EXIT_TESTS = 0


def _read_flag(flag) -> bool:
    global EXIT_TESTS
    EXIT_TESTS += 1
    return bool(flag.item())


def pair_lookup_cat(u, v, pair_rows_cat, table_mask):
    """(u, v) -> merged id, or -1: one row gather per cuckoo half.

    ``pair_rows_cat`` is the two cuckoo tables stacked along rows ([2T, 4]
    of (u, v, id, safe), table 1 offset by T = table_mask + 1).
    """
    T = table_mask + 1
    s1 = _mix(u, v, _H1, table_mask)
    s2 = _mix(u, v, _H2, table_mask)
    r1 = take_clip(pair_rows_cat[:T], s1)
    r2 = take_clip(pair_rows_cat[T:], s2)
    hit1 = (r1[..., 0] == u) & (r1[..., 1] == v)
    hit2 = (r2[..., 0] == u) & (r2[..., 1] == v)
    out = torch.where(hit1, r1[..., 2], -1)
    return torch.where(hit2, r2[..., 2], out)


def t3_round(ids, rank, active, pair_rows_cat, table_mask):
    """ONE sequential merge step per column of a [W, R] state (the
    reference's single iteration, ``M/GptBytePairEncoding.java:223-263``).

    Returns (ids, rank, active) after the step.
    """
    W, _R = ids.shape
    subl = torch.arange(W, dtype=torch.int32, device=ids.device)[:, None]
    BIG = W + 1

    def at_sublane(x, m, fill):
        return torch.where(subl == m[None, :], x, fill).amin(dim=0)

    m = torch.argmin(rank, dim=0).to(torch.int32)
    minval = rank.amin(dim=0)
    do = minval < MAX_RANK

    after_m = active & (subl > m[None, :])
    nxt = torch.where(after_m, subl, BIG).amin(dim=0)
    prv = torch.where(active & (subl < m[None, :]), subl, -1).amax(dim=0)
    nxt2 = torch.where(active & (subl > nxt[None, :]), subl, BIG).amin(dim=0)

    one_m = subl == m[None, :]
    one_n = subl == nxt[None, :]
    do_row = do[None, :]
    new_ids = torch.where(one_m & do_row, minval[None, :], ids)
    new_active = active & ~(one_n & do_row)

    id_m = minval
    id_prv = at_sublane(ids, prv, MAX_RANK)
    id_nxt2 = at_sublane(ids, nxt2, MAX_RANK)
    # both neighbour-rank sites in one batched lookup (one row gather)
    found = pair_lookup_cat(
        torch.stack([id_m, id_prv]), torch.stack([id_nxt2, id_m]),
        pair_rows_cat, table_mask,
    )
    found = torch.where(found < 0, MAX_RANK, found)
    rank_m = torch.where(nxt2 <= W, found[0], MAX_RANK)
    rank_prv = torch.where(prv >= 0, found[1], MAX_RANK)

    one_p = subl == prv[None, :]
    new_rank = torch.where(one_m & do_row, rank_m[None, :], rank)
    new_rank = torch.where(one_p & do_row, rank_prv[None, :], new_rank)
    new_rank = torch.where(one_n & do_row, MAX_RANK, new_rank)
    return new_ids, new_rank, new_active


def rank_from_state(ids, active, pair_rows_cat, table_mask):
    """Pair ranks for a mid-merge [W, R] state: rank[w] = vocabulary rank of
    (span w, next active span in its column), MAX_RANK when absent. ONE
    full-matrix batched lookup; used to enter the sequential rounds after a
    batched round or a compaction."""
    (nxt_id,) = excl_rev([torch.where(active, ids, -1)], ["last"])
    found = pair_lookup_cat(ids, nxt_id, pair_rows_cat, table_mask)
    has = active & (nxt_id >= 0)
    return torch.where(has & (found >= 0), found, MAX_RANK)


def _exit_test(rank, _active):
    return rank.amin() < MAX_RANK


def _loop(step, more, state, rounds):
    """Run ``state = step(*state)`` in one of the loop forms of
    :func:`run_rounds`; ``more(*state)`` is the exit test. Returns (state,
    rounds run: an int, or for ``DEVICE`` a 0-d int32 tensor)."""
    global MERGE_ROUNDS
    if rounds == DEVICE:
        return loop.while_loop(more, step, state, _read_flag)
    ran = 0
    while (ran < rounds) if rounds is not None else _read_flag(more(*state)):
        state = step(*state)
        ran += 1
    MERGE_ROUNDS += ran
    return state, ran


def run_rounds(ids, rank, active, pair_rows_cat, table_mask, rounds=None,
               more=None):
    """Sequential merge rounds over a [W, R] state, in any loop form.

    ``rounds=None`` (cold): a round runs while ``more(rank, active)`` holds
    (by default: some column has a mergeable pair), one 0-d bool read back
    per test. ``rounds=k``: exactly ``k`` rounds, nothing read back.
    ``rounds=DEVICE``: while ``more`` holds, tested on the device
    (:func:`.loop.while_loop`); ``more`` must not launch a prefix scan.

    Returns (ids, rank, active, rounds run: an int, or for ``DEVICE`` a 0-d
    int32 tensor).
    """
    test = more or _exit_test
    (ids, rank, active), ran = _loop(
        lambda ids, rank, active: t3_round(ids, rank, active, pair_rows_cat, table_mask),
        lambda _ids, rank, active: test(rank, active),
        (ids, rank, active), rounds,
    )
    return ids, rank, active, ran


def merge_rows_t3(mat_t, lens, byte_to_id, byte_pair_id, pair_rows_cat,
                  table_mask, *, rounds=None):
    """Exact merge of a transposed piece matrix (column r holds piece r's
    bytes in rows 0..lens[r]-1). Semantics identical to the reference merge
    loop (``M/GptBytePairEncoding.java:200-275``).

    ``rounds``: see :func:`run_rounds`. Returns (ids_t int32[W, R],
    active_t bool[W, R], rounds run).
    """
    W, R = mat_t.shape
    dev = mat_t.device
    subl = torch.arange(W, dtype=torch.int32, device=dev)[:, None]
    b = mat_t.to(torch.int32)

    active = subl < lens[None, :]
    ids = torch.where(active, take_clip(byte_to_id, b), -1)

    b_next = torch.cat([b[1:, :], b.new_zeros((1, R))], dim=0)
    is_pair = subl + 1 < lens[None, :]
    rank = torch.where(is_pair, take_clip(byte_pair_id, b * 256 + b_next), -1)
    rank = torch.where(rank < 0, MAX_RANK, rank)

    ids, _rank, active, ran = run_rounds(
        ids, rank, active, pair_rows_cat, table_mask, rounds
    )
    return ids, active, ran


def row_round(ids, rank, active, pair_rows_cat, table_mask):
    """ONE sequential merge step per row of a row-major [R, L] state (the
    long-piece fallback's layout; the step of :func:`t3_round`). The
    leftmost minimum of each row is computed as the smallest lane that holds
    the row's minimum, which does not depend on how an ``argmin`` breaks
    ties.

    Returns (ids, rank, active) after the step.
    """
    L = ids.shape[1]
    lanes = torch.arange(L, dtype=torch.int32, device=ids.device)[None, :]

    def at_lane(x, m):
        return x.gather(1, m[:, None].to(torch.int64))[:, 0]

    minval = rank.amin(dim=1)
    m = torch.where(rank == minval[:, None], lanes, L).amin(dim=1)
    do = minval < MAX_RANK

    m_col = m[:, None]
    nxt = torch.where(active & (lanes > m_col), lanes, L).amin(dim=1)
    prv = torch.where(active & (lanes < m_col), lanes, -1).amax(dim=1)
    nxt2 = torch.where(active & (lanes > nxt[:, None]), lanes, L).amin(dim=1)

    # merged token id == the pair rank (tiktoken rank == id)
    one_m = lanes == m_col
    one_n = lanes == nxt[:, None]
    do_col = do[:, None]
    new_ids = torch.where(one_m & do_col, minval[:, None], ids)
    new_active = active & ~(one_n & do_col)

    # the two affected neighbour ranks, before the "removal"
    id_m = minval
    id_prv = at_lane(ids, prv.clamp_min(0))
    id_nxt2 = at_lane(ids, nxt2.clamp(max=L - 1))
    found = pair_lookup_cat(
        torch.stack([id_m, id_prv]), torch.stack([id_nxt2, id_m]),
        pair_rows_cat, table_mask,
    )
    found = torch.where(found < 0, MAX_RANK, found)
    rank_m = torch.where(nxt2 < L, found[0], MAX_RANK)
    rank_prv = torch.where(prv >= 0, found[1], MAX_RANK)

    one_p = lanes == prv[:, None]
    new_rank = torch.where(one_m & do_col, rank_m[:, None], rank)
    new_rank = torch.where(one_p & do_col, rank_prv[:, None], new_rank)
    new_rank = torch.where(one_n & do_col, MAX_RANK, new_rank)
    return new_ids, new_rank, new_active


def merge_rows(byte_mat, lens, byte_to_id, byte_pair_id, pair_rows_cat,
               table_mask, *, rounds=None):
    """Exact merge of a row-major padded piece matrix (the long-piece
    fallback's layout; semantics as :func:`merge_rows_t3`, one
    :func:`row_round` a round).

    The reference function probes the scalar cuckoo tables; this one probes
    the same entries through ``pair_rows_cat`` (columns 0-2 hold the same
    u, v, id).

    Args:
      byte_mat: uint8[R, L] piece bytes, zero-padded.
      lens: int32[R] piece byte lengths (<= L).
      rounds: the loop form (see :func:`run_rounds`).

    Returns (ids int32[R, L], token id per surviving span, junk at inactive
    lanes; active bool[R, L], the surviving spans; rounds run: an int, or
    for ``DEVICE`` a 0-d int32 tensor).
    """
    R, L = byte_mat.shape
    dev = byte_mat.device
    lanes = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    b = byte_mat.to(torch.int32)

    active = lanes < lens[:, None]
    ids = torch.where(active, take_clip(byte_to_id, b), -1)

    # seed pair ranks: spans are single bytes, one gather into the 64K table
    b_next = torch.cat([b[:, 1:], b.new_zeros((R, 1))], dim=1)
    is_pair = lanes + 1 < lens[:, None]
    rank = torch.where(is_pair, take_clip(byte_pair_id, b * 256 + b_next), -1)
    rank = torch.where(rank < 0, MAX_RANK, rank)

    (ids, _rank, active), ran = _loop(
        lambda ids, rank, active: row_round(ids, rank, active, pair_rows_cat, table_mask),
        lambda _ids, rank, active: _exit_test(rank, active),
        (ids, rank, active), rounds,
    )
    return ids, active, ran
