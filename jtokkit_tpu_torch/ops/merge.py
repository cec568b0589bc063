"""Device byte-pair merge, vectorized across pieces.

Counterpart of ``jtokkit_tpu/ops/merge.py`` (``pair_lookup_cat``,
``t3_round``, ``merge_rows_t3``, and the row-major ``merge_rows`` of the
long-piece fallback). In Stage B pieces are columns of a [W, R] matrix
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
(``rounds=DEVICE``) leaves the rounds it ran on the device, unread, as a
0-d int32 tensor; in the plain loop it is the cold loop, which returns its
count that way. :data:`MERGE_ROUNDS` counts the rounds of the cold and fixed
forms where they run; the device form's rounds are added by whoever reads
its counter back. :data:`EXIT_TESTS` counts the flags read back.

That loop is the plain version of :func:`merge_rows_t3`
(:func:`merge_rows_t3_plain`), and the wrapper takes it only for CPU
tensors. A CUDA tensor goes to ONE launch of the hand-written kernel in
``csrc/merge.cu`` (:func:`merge_rows_t3_cuda`) and nowhere else: each piece
runs its own sequential merge to its end, with no global round, since the
merge of one piece depends on no other. Every loop form maps onto the
kernel's limit on merges per piece: after ``k`` rounds each piece has made
``min(k, its merges)`` merges, so ``rounds=k`` is the limit ``k``; the cold
and device forms have no limit, and the kernel writes the rounds the loop
would have run (the most merges of any piece) into a 0-d int32 counter,
which the device form returns and the cold form reads back once (one exit
test). :data:`KERNEL_LAUNCHES` counts the wrapper's launches,
:data:`CAPTURED_CALLS` the launches recorded into a CUDA graph instead. The
kernel replaces no TPU kernel: it is the counterpart of the JAX package's
XLA while loop around ``merge_rows_t3``, bound by the longest piece's
chain of dependent lookups, not by bytes. The row-major :func:`merge_rows`
of the long-piece fallback is the same function of its pieces: on CUDA it
runs on the kernel over the transposed matrix, and its plain version
(:func:`merge_rows_plain`, the CPU path) is :func:`row_round`'s loop.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import KernelLibrary, cuda_device_index
from .classify import take_clip
from .stage4 import _mix

MAX_RANK = 0x7FFFFFFF
# the device form of merge_rows_t3 and merge_rows: the rounds stay on the device
DEVICE = "device"

_H1 = (0x9E3779B1, 0x85EBCA77, 0x2C1B3C6D)
_H2 = (0xC2B2AE3D, 0x27D4EB2F, 0x165667B1)

# merge rounds run by merge_rows_t3 and merge_rows since the counter was last
# reset (the device form's are added where its counter is read back)
MERGE_ROUNDS = 0
# exit tests of the cold loops: each is one 0-d bool read back to the host,
# counted where it is read
EXIT_TESTS = 0
# launches of the merge kernel by merge_rows_t3_cuda, and launches it
# recorded into a CUDA graph under capture instead (each replay runs them)
KERNEL_LAUNCHES = 0
CAPTURED_CALLS = 0

# the kernel's widest bucket: a position takes 12 bits of its packed key
MAX_LANES = 1 << 12
# ranks the packed key holds: (rank << 12) | position below 0xFFFFFFFF
KEY_RANK_LIMIT = (1 << 20) - 1
_NO_LIMIT = 0x7FFFFFFF


def _declare(lib: ctypes.CDLL) -> None:
    vp = ctypes.c_void_p
    lib.jt_merge_t3.argtypes = [
        vp, vp, vp, vp, vp, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_int, vp, vp, vp, ctypes.c_int, vp,
    ]
    lib.jt_merge_t3.restype = ctypes.c_int
    for fn in (lib.jt_merge_max_lanes, lib.jt_merge_key_rank_limit):
        fn.argtypes = []
        fn.restype = ctypes.c_int
    if (lib.jt_merge_max_lanes(), lib.jt_merge_key_rank_limit()) != (MAX_LANES, KEY_RANK_LIMIT):
        raise RuntimeError("the merge library's key layout differs from ops/merge.py")


LIBRARY = KernelLibrary("merge", _declare)


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


def _loop(step, state, rounds):
    """Run ``state = step(*state)`` over (ids, rank, active) in one of the
    loop forms of the module docstring: ``rounds=k`` exactly ``k`` times,
    the cold and device forms while some pair is left to merge, reading
    that test back after every round. Returns (state, rounds run: an int,
    or for ``DEVICE`` a 0-d int32 tensor on the state's device)."""
    global MERGE_ROUNDS
    device = rounds == DEVICE
    fixed = rounds is not None and not device
    ran = 0
    while ran < rounds if fixed else _read_flag(state[1].amin() < MAX_RANK):
        state = step(*state)
        ran += 1
    if device:
        return state, torch.tensor(ran, dtype=torch.int32, device=state[0].device)
    MERGE_ROUNDS += ran
    return state, ran


def merge_rows_t3_plain(mat_t, lens, byte_to_id, byte_pair_id, pair_rows_cat,
                        table_mask, *, rounds=None):
    """Exact merge of a transposed piece matrix (column r holds piece r's
    bytes in rows 0..lens[r]-1, ``0 <= lens[r] <= W``) as rounds of
    :func:`t3_round`, on any device: the plain version of
    :func:`merge_rows_t3`. Semantics identical to the reference merge loop
    (``M/GptBytePairEncoding.java:200-275``).

    ``rounds``: ``None``, ``k`` or ``DEVICE`` (the module docstring).
    Returns (ids_t int32[W, R], active_t bool[W, R], rounds run).
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

    (ids, _rank, active), ran = _loop(
        lambda ids, rank, active: t3_round(ids, rank, active, pair_rows_cat, table_mask),
        (ids, rank, active), rounds,
    )
    return ids, active, ran


def _max_rank(table: torch.Tensor, column=None) -> int:
    """The largest rank a table holds (``column`` of its rows), read once per
    table and kept on the tensor until it is written in place."""
    cached = getattr(table, "_jtokkit_max_rank", None)
    if cached is not None and cached[0] == table._version:
        return cached[1]
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "merge kernel: the table's ranks are checked by one read, which a"
            " capture cannot make: run the merge once before capturing it"
        )
    vals = table if column is None else table[:, column]
    value = int(vals.max()) if vals.numel() else -1
    table._jtokkit_max_rank = (table._version, value)
    return value


def merge_rows_t3_cuda(mat_t, lens, byte_to_id, byte_pair_id, pair_rows_cat,
                       table_mask, *, rounds=None):
    """:func:`merge_rows_t3` on CUDA tensors: ONE launch of the kernel in
    ``csrc/merge.cu`` (or its recording, under a capture), every piece
    merged to its end or to ``rounds=k`` merges. Returns what the plain
    version returns for the same ``rounds``; the cold form reads the
    kernel's round counter back once (one exit test)."""
    global KERNEL_LAUNCHES, CAPTURED_CALLS, MERGE_ROUNDS, EXIT_TESTS
    W, R = mat_t.shape
    dev = mat_t.device
    if dev.type != "cuda":
        raise ValueError("merge_rows_t3_cuda takes CUDA tensors")
    tables = (lens, byte_to_id, byte_pair_id, pair_rows_cat)
    if any(x.device != dev for x in tables):
        raise ValueError("the merge's tensors must lie on one device")
    if mat_t.dtype != torch.uint8 or any(x.dtype != torch.int32 for x in tables):
        raise TypeError("the merge takes a uint8 matrix and int32 lengths and tables")
    if not all(x.is_contiguous() for x in (mat_t,) + tables):
        raise ValueError("the merge's tensors must be contiguous")
    T = table_mask + 1
    if (lens.shape != (R,) or byte_to_id.shape != (256,)
            or byte_pair_id.shape != (1 << 16,) or T & table_mask
            or pair_rows_cat.shape != (2 * T, 4) or pair_rows_cat.data_ptr() % 16):
        raise ValueError("the merge's shapes do not fit the kernel")
    if not 1 <= W <= MAX_LANES:
        raise ValueError(f"a bucket of {W} lanes is wider than the kernel's {MAX_LANES}")
    top = max(_max_rank(byte_pair_id), _max_rank(pair_rows_cat, 2))
    if top >= KEY_RANK_LIMIT:
        raise ValueError(
            f"rank {top} does not fit the merge kernel's key (ranks below {KEY_RANK_LIMIT})")
    device = rounds == DEVICE
    limit = _NO_LIMIT if rounds is None or device else int(rounds)
    if limit < 0:
        raise ValueError("rounds must not be negative")
    ids = torch.empty((W, R), dtype=torch.int32, device=dev)
    active = torch.empty((W, R), dtype=torch.bool, device=dev)
    counter = (torch.zeros((), dtype=torch.int32, device=dev)
               if rounds is None or device else None)
    if R:
        rc = LIBRARY.load().jt_merge_t3(
            mat_t.data_ptr(), lens.data_ptr(), byte_to_id.data_ptr(),
            byte_pair_id.data_ptr(), pair_rows_cat.data_ptr(), table_mask, W, R,
            limit, ids.data_ptr(), active.data_ptr(),
            None if counter is None else counter.data_ptr(),
            cuda_device_index(dev), torch.cuda.current_stream(dev).cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"merge kernel launch failed: CUDA error {rc}")
        if torch.cuda.is_current_stream_capturing():
            CAPTURED_CALLS += 1
        else:
            KERNEL_LAUNCHES += 1
    if device:
        return ids, active, counter
    if rounds is None:
        EXIT_TESTS += 1
        ran = int(counter.item())
    else:
        ran = limit
    MERGE_ROUNDS += ran
    return ids, active, ran


def merge_rows_t3(mat_t, lens, byte_to_id, byte_pair_id, pair_rows_cat,
                  table_mask, *, rounds=None):
    """Exact merge of a transposed piece matrix (column r holds piece r's
    bytes in rows 0..lens[r]-1, ``0 <= lens[r] <= W``). Semantics identical
    to the reference merge loop (``M/GptBytePairEncoding.java:200-275``).

    CUDA tensors go to the kernel (:func:`merge_rows_t3_cuda`), CPU tensors
    to the plain version (:func:`merge_rows_t3_plain`). ``rounds``: see the
    module docstring. Returns (ids_t int32[W, R], active_t bool[W, R],
    rounds run: an int, or for ``DEVICE`` a 0-d int32 tensor).
    """
    dev = mat_t.device
    if dev.type == "cuda":
        return merge_rows_t3_cuda(mat_t, lens, byte_to_id, byte_pair_id,
                                  pair_rows_cat, table_mask, rounds=rounds)
    if dev.type != "cpu":
        raise ValueError(f"no merge for device {dev}")
    return merge_rows_t3_plain(mat_t, lens, byte_to_id, byte_pair_id,
                               pair_rows_cat, table_mask, rounds=rounds)


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


def merge_rows_plain(byte_mat, lens, byte_to_id, byte_pair_id, pair_rows_cat,
                     table_mask, *, rounds=None):
    """Exact merge of a row-major padded piece matrix as rounds of
    :func:`row_round`, on any device: the plain version of
    :func:`merge_rows`, whose arguments and results it takes and gives."""
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
        (ids, rank, active), rounds,
    )
    return ids, active, ran


def merge_rows(byte_mat, lens, byte_to_id, byte_pair_id, pair_rows_cat,
               table_mask, *, rounds=None):
    """Exact merge of a row-major padded piece matrix (the long-piece
    fallback's layout; semantics as :func:`merge_rows_t3`). CUDA tensors go
    to the merge kernel over the transposed matrix
    (:func:`merge_rows_t3_cuda`, ``L <= MAX_LANES``), CPU tensors to the
    plain version (:func:`merge_rows_plain`).

    The reference function probes the scalar cuckoo tables; this one probes
    the same entries through ``pair_rows_cat`` (columns 0-2 hold the same
    u, v, id).

    Args:
      byte_mat: uint8[R, L] piece bytes, zero-padded.
      lens: int32[R] piece byte lengths (<= L).
      rounds: the loop form (see the module docstring).

    Returns (ids int32[R, L], token id per surviving span, junk at inactive
    lanes; active bool[R, L], the surviving spans; rounds run: an int, or
    for ``DEVICE`` a 0-d int32 tensor).
    """
    dev = byte_mat.device
    if dev.type == "cuda":
        ids_t, active_t, ran = merge_rows_t3_cuda(
            byte_mat.T.contiguous(), lens, byte_to_id, byte_pair_id, pair_rows_cat,
            table_mask, rounds=rounds)
        return ids_t.T, active_t.T, ran
    if dev.type != "cpu":
        raise ValueError(f"no merge for device {dev}")
    return merge_rows_plain(byte_mat, lens, byte_to_id, byte_pair_id, pair_rows_cat,
                            table_mask, rounds=rounds)
