"""Stage B (one merge bucket) and Stage C (counts, offsets, token scatters).

Counterpart of ``jtokkit_tpu/ops/pipeline.py`` (``merge_bucket_v3`` and the
Stage C functions). The reference's ``mode="drop"`` scatters write their
dropped entries to a spare slot one past the end, which is sliced off.
"""

from __future__ import annotations

import torch

from . import merge
from .classify import take_clip


def merge_bucket_v3(
    buf, starts, lens, miss_sorted, group_start_b, count_b,
    byte_to_id, byte_pair_id, pair_rows_cat, table_mask,
    *, lanes: int, cap: int, rounds=None,
):
    """Exact merge of one bucket's pieces; ``cap`` columns, of which the
    first ``count_b`` are live, starting at ``group_start_b`` in
    ``miss_sorted``. Both may be ints or 0-d device tensors sliced from the
    piece table (as the reference's jit traces them), so one recorded graph
    serves every count that quantizes to ``cap``. ``rounds`` is
    :func:`merge.merge_rows_t3`'s.

    Returns (cols int32[cap] piece indices, ids int32[lanes, cap],
    active bool[lanes, cap], rounds run).
    """
    cols, live, c_len, mat_t = bucket_matrix(
        buf, starts, lens, miss_sorted, group_start_b, count_b,
        lanes=lanes, cap=cap,
    )
    ids, active, ran = merge.merge_rows_t3(
        mat_t, c_len, byte_to_id, byte_pair_id, pair_rows_cat, table_mask,
        rounds=rounds,
    )
    active = active & live[None, :]
    return cols, ids, active, ran


def bucket_matrix(buf, starts, lens, miss_sorted, group_start_b, count_b,
                  *, lanes: int, cap: int):
    """One bucket's pieces as columns of a byte matrix (``group_start_b``
    and ``count_b`` ints or 0-d tensors).

    Returns (cols int32[cap] piece indices, live bool[cap], c_len int32[cap]
    piece lengths (0 where dead), mat_t uint8[lanes, cap]).
    """
    N = buf.shape[0]
    M = miss_sorted.shape[0]
    dev = buf.device
    r = torch.arange(cap, dtype=torch.int32, device=dev)
    take = torch.clamp(group_start_b + r, max=M - 1)
    cols = miss_sorted.index_select(0, take)
    live = r < count_b
    c_start = torch.where(live, starts.index_select(0, cols), 0)
    c_len = torch.where(live, lens.index_select(0, cols), 0)

    grows = torch.arange(lanes, dtype=torch.int32, device=dev)[:, None]
    gidx = torch.clamp(c_start[None, :] + grows, max=N - 1)
    mat_t = torch.where(grows < c_len[None, :], take_clip(buf, gidx), 0)
    return cols, live, c_len, mat_t


def counts_init(hit, n_pieces):
    P = hit.shape[0]
    piece_valid = torch.arange(P, dtype=torch.int32, device=hit.device) < n_pieces
    return (piece_valid & (hit >= 0)).to(torch.int32)


def counts_add_bucket(counts, cols, active):
    return counts.index_add(0, cols, active.sum(dim=0, dtype=torch.int32))


def make_offsets(counts, n_pieces):
    P = counts.shape[0]
    offsets = torch.cat([
        counts.new_zeros(1), torch.cumsum(counts, 0, dtype=torch.int32)
    ])
    # index_select, not offsets[...]: indexing by a 0-d tensor reads it back
    n_tokens = offsets.index_select(
        0, torch.clamp(n_pieces, max=P).reshape(1)
    ).reshape(())
    return offsets, n_tokens


def scatter_hits(n_out: int, hit, offsets, n_pieces):
    P = hit.shape[0]
    piece_valid = torch.arange(P, dtype=torch.int32, device=hit.device) < n_pieces
    tgt = torch.where(piece_valid & (hit >= 0), offsets[:P], n_out)
    tokens = hit.new_zeros(n_out + 1)
    tokens.scatter_(0, tgt.to(torch.int64), hit.clamp_min(0))
    return tokens[:n_out]


def scatter_bucket(tokens, ids, active, cols, offsets):
    n_out = tokens.shape[0]
    pos = torch.cumsum(active, dim=0, dtype=torch.int32) - 1
    tgt = torch.where(active, offsets.index_select(0, cols)[None, :] + pos, n_out)
    out = torch.cat([tokens, tokens.new_zeros(1)])
    out.scatter_(0, tgt.reshape(-1).to(torch.int64), ids.reshape(-1))
    return out[:n_out]
