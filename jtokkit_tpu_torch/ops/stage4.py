"""Stage A: classify, piece boundaries, piece table, word-table hits, miss
groups.

Counterpart of ``jtokkit_tpu/ops/stage4.py``. Per chunk it runs:

1. classify (arithmetic for pure-ASCII chunks, table lookup otherwise),
2. piece starts from three fused multi-leaf scans (:mod:`.scan`; two
   forward, one reverse; the gpt2 pattern needs no second forward scan),
3. the piece stitch (:func:`masked_rows`, one more scan),
4. the whole-piece word-table probe,
5. miss compaction (:func:`masked_positions`, one more scan) and the
   stable bucket argsort.

So a cl100k chunk makes 5 scan calls, a gpt2 chunk 4. Everything else is
elementwise, sorts, gathers and scatters.

Hashes are uint32 arithmetic in the reference. Here they run in int64 with
``& 0xFFFFFFFF`` (torch's ``>>`` on int32 is arithmetic, and its int32
products would not wrap the same way), and :func:`_i32` turns the uint32 bit
pattern back into int32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..engine.charclass import CRLF, LETTER, NUMBER, OTHER, PAD, SPACE, WS
from . import classify as classify_ops
from . import scan
from .classify import classify_ascii, take_clip

_BOS = -1
_APO = 0x27
_ONE_CHAR = (ord("s"), ord("t"), ord("m"), ord("d"))
_TWO_CHAR = ((ord("r"), ord("e")), (ord("v"), ord("e")), (ord("l"), ord("l")))

_H1 = (0x9E3779B1, 0x85EBCA77, 0x2C1B3C6D)
_H2 = (0xC2B2AE3D, 0x27D4EB2F, 0x165667B1)
_LEN_MIX = 0x01000193
_W2_MIX = 0x7FEB352D
_W3_MIX = 0x846CA68B
_M32 = 0xFFFFFFFF

# overflow bits (meta[0]); the engine retries with the roomier variant on
# CAPACITY, and takes the host path on PIECE_LEN
OVERFLOW_CAPACITY = 1   # piece table or miss table too small for this text
OVERFLOW_PIECE_LEN = 2  # a single piece exceeds the largest merge bucket

BUCKET_WIDTHS = (8, 16, 32, 64, 128, 256, 384, 512, 4096)
MAX_PIECE_LEN = BUCKET_WIDTHS[-1]
META_LEN = 2 + len(BUCKET_WIDTHS)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """The uint32 value of an int32 bit pattern, as int64."""
    return x.to(torch.int64) & _M32


def _i32(x: torch.Tensor) -> torch.Tensor:
    """The int32 with the bit pattern of a uint32 held in int64."""
    x = x & _M32
    return (x - ((x & 0x80000000) << 1)).to(torch.int32)


def _mix(u, v, consts, mask):
    a, b, c = consts
    h = ((_u32(u) * a) & _M32) ^ ((_u32(v) * b) & _M32)
    h = h ^ (h >> 15)
    h = (h * c) & _M32
    h = h ^ (h >> 13)
    return (h & mask).to(torch.int32)


def _full(k: int, fill, like: torch.Tensor) -> torch.Tensor:
    return torch.full((k,), fill, dtype=like.dtype, device=like.device)


def _shift_right(x, fill, k: int = 1):
    return torch.cat([_full(k, fill, x), x[:-k]])


def _shift_left(x, fill, k: int = 1):
    return torch.cat([x[k:], _full(k, fill, x)])


def piece_starts_v4(info: dict, pattern: str, *, ascii_chars: bool = False):
    """Piece-start mask and per-byte doc-end positions, gather-free.

    Every run-structure quantity the boundary rules need rides a leaf of one
    of three multi-leaf scans. ``ascii_chars=True`` (every char is one byte)
    drops the char-ordinal and last-char-start leaves.

    Returns (mask bool[n], doc_end_pos int32[n]).
    """
    if pattern not in ("gpt2", "cl100k"):
        raise ValueError(f"unsupported device pattern {pattern!r}")
    is_cl = pattern == "cl100k"

    cls = info["cls"]
    start = info["is_start"]
    byte = info["byte"]
    n = cls.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=cls.device)

    prev_cls = _shift_right(cls, _BOS)
    if ascii_chars:
        char_start_pos = idx
    else:
        s1 = _shift_right(start, False)
        s2 = _shift_right(s1, False)
        char_start_pos = torch.where(
            start, idx,
            torch.where(s1, idx - 1, torch.where(s2, idx - 2, idx - 3)),
        )

    is_ws = (cls >= WS) & (cls <= SPACE)
    is_crlf_b = cls == CRLF
    invalid = cls == PAD

    ws_run_start_b = is_ws & ~_shift_right(is_ws, False)
    digit_run_start = start & (cls == NUMBER) & (prev_cls != NUMBER)

    # ---- forward scan 1: whole-run prefixes independent of `absorbed` ----
    #   rsp+pro (packed): ws run-start position << 1 | whether the char
    #     before the run is OTHER
    #   lnc: last non-CRLF byte position (cl100k CRLF-prefix absorption)
    #   cord: character ordinal (only needed for multibyte digits)
    #   dro: digit-run start (byte idx when ascii)
    rsp_pro_leaf = torch.where(
        ws_run_start_b, idx * 2 + (prev_cls == OTHER).to(torch.int32), -1
    )
    leaves1 = [rsp_pro_leaf]
    kinds1 = ["max"]
    if is_cl:
        leaves1.append(torch.where(~is_crlf_b, idx, -1))
        kinds1.append("max")
    if is_cl and not ascii_chars:
        leaves1.append(start.to(torch.int32))
        kinds1.append("add")
    if is_cl and ascii_chars:
        leaves1.append(torch.where(digit_run_start, idx, -1))
        kinds1.append("max")

    out1 = scan.scan_leaves(leaves1, kinds1)
    rsp = out1[0] >> 1
    pro = out1[0] & 1
    if is_cl:
        lnc = out1[1]
    if is_cl and not ascii_chars:
        char_ord = out1[2] - 1
    if is_cl and ascii_chars:
        dro = out1[2]

    if is_cl:
        in_crlf_prefix = is_crlf_b & (lnc < rsp)
        absorbed = in_crlf_prefix & (pro == 1)
        eff_ws = is_ws & ~absorbed
    else:
        eff_ws = is_ws

    eff_run_start_b = eff_ws & ~_shift_right(eff_ws, False)

    # ---- forward scan 2 (cl100k only): quantities depending on `absorbed`
    if is_cl:
        leaves2 = [
            torch.where(eff_run_start_b, idx, -1),
            torch.where(is_crlf_b & eff_ws, idx, -1),
        ]
        if not ascii_chars:
            leaves2.append(torch.where(digit_run_start, char_ord, -1))
        out2 = scan.scan_leaves(leaves2, ["max"] * len(leaves2))
        ers, lcp = out2[0], out2[1]
        if not ascii_chars:
            dro = out2[2]
    else:
        ers = rsp
        lcp = torch.full_like(idx, -1)

    # ---- reverse scan 3: values defined at ws run-END bytes + doc ends ----
    run_end_b = is_ws & ~_shift_left(is_ws, False)
    next_cls = _shift_left(cls, PAD)
    # rep+nar share the run-end mask: pack (run_end_pos << 3 | next class)
    leaves3 = [
        torch.where(run_end_b, idx * 8 + next_cls, -1),
        torch.where(invalid, idx, -1),
    ]
    if is_cl:
        leaves3.append(torch.where(run_end_b, lcp + 1, -1))
    if not ascii_chars:
        leaves3.append(torch.where(run_end_b, char_start_pos, -1))

    out3 = scan.scan_leaves(leaves3, ["last"] * len(leaves3), reverse=True)
    rep_nar, die = out3[0], out3[1]
    run_end_pos = rep_nar >> 3
    next_after_run = torch.where(rep_nar >= 0, rep_nar & 7, -1)
    if is_cl:
        last_crlf_whole = out3[2] - 1
    last_char_start = run_end_pos if ascii_chars else out3[-1]
    doc_end_pos = torch.where(die >= 0, die, n)
    if is_cl and ascii_chars:
        char_ord = idx  # only differences are used, within single-byte runs
    # the (?!\S) lookahead fails: a non-whitespace char follows the run
    followed_by_nonws = (next_after_run != PAD) & (next_after_run >= 0)

    # ---- whitespace piece starts & forward glue ----------------------------
    if is_cl:
        crlf_present = last_crlf_whole >= ers
        sub_start = torch.where(crlf_present, last_crlf_whole + 1, ers)
        has_remainder = sub_start <= run_end_pos
        ws_piece_start = eff_ws & start & (
            (idx == ers)
            | (crlf_present & has_remainder & (idx == sub_start))
            | (followed_by_nonws & has_remainder & (idx == last_char_start)
               & (idx != sub_start))
        )
        glue_ok = (next_after_run == LETTER) | (
            (next_after_run == OTHER) & (byte == 0x20)
        )
        glue_fwd = (
            eff_ws & start & followed_by_nonws & has_remainder
            & (idx == last_char_start) & glue_ok
        )
    else:
        ws_piece_start = is_ws & start & (
            (idx == rsp)
            | (followed_by_nonws & (idx == last_char_start) & (idx != rsp))
        )
        glue_fwd = (
            is_ws & start & followed_by_nonws
            & (idx == last_char_start) & (byte == 0x20)
        )

    # glued_back[i] = glue_fwd at the previous char's start byte; UTF-8 chars
    # are <= 4 bytes, so a bounded shift-select replaces the gather
    prev_char = _shift_right(char_start_pos, -1)
    glued_back = torch.zeros_like(start)
    for k in (1, 2, 3, 4):
        glued_back = glued_back | (
            _shift_right(glue_fwd, False, k) & (prev_char == idx - k)
        )

    # ---- punctuation runs -------------------------------------------------
    other_piece_start = start & (cls == OTHER) & (prev_cls != OTHER) & ~glued_back

    # ---- contractions -----------------------------------------------------
    b1 = _shift_left(byte, 0)
    b2 = _shift_left(byte, 0, 2)
    one = torch.zeros_like(start)
    two = torch.zeros_like(start)
    if is_cl:
        l1 = torch.where((b1 >= 65) & (b1 <= 90), b1 + 32, b1)
        l2 = torch.where((b2 >= 65) & (b2 <= 90), b2 + 32, b2)
        for c in _ONE_CHAR:
            one = one | (l1 == c)
        for c1, c2 in _TWO_CHAR:
            two = two | ((l1 == c1) & (l2 == c2))
        # U+017F LONG S folds to 's' under Java UNICODE_CASE (UTF-8 C5 BF)
        long_s = (b1 == 0xC5) & (b2 == 0xBF)
    else:
        for c in _ONE_CHAR:
            one = one | (b1 == c)
        for c1, c2 in _TWO_CHAR:
            two = two | ((b1 == c1) & (b2 == c2))
        long_s = torch.zeros_like(start)

    apo_start = (byte == _APO) & other_piece_start
    contraction2 = apo_start & one
    contraction3 = apo_start & ~one & (two | long_s)
    contraction = contraction2 | contraction3

    suppress = _shift_right(contraction, False) | _shift_right(contraction3, False, 2)
    forced = _shift_right(contraction2, False, 2) | _shift_right(contraction3, False, 3)

    # ---- letter runs ------------------------------------------------------
    if is_cl:
        pre_flag = other_piece_start & ~contraction
        prev_is_prefix = torch.zeros_like(start)
        for k in (1, 2, 3, 4):
            prev_is_prefix = prev_is_prefix | (
                _shift_right(pre_flag, False, k) & (prev_char == idx - k)
            )
        prev_is_prefix = prev_is_prefix & (prev_cls == OTHER)
        letter_glued = glued_back | prev_is_prefix
    else:
        letter_glued = glued_back
    letter_piece_start = start & (cls == LETTER) & (
        ((prev_cls != LETTER) & ~letter_glued) | forced
    )

    # ---- number runs ------------------------------------------------------
    if is_cl:
        pos_in_run = char_ord - dro
        number_piece_start = start & (cls == NUMBER) & (pos_in_run % 3 == 0)
    else:
        number_piece_start = start & (cls == NUMBER) & (
            (prev_cls != NUMBER) & ~glued_back
        )

    mask = torch.where(
        is_ws,
        ws_piece_start,
        torch.where(
            cls == LETTER,
            letter_piece_start,
            torch.where(cls == NUMBER, number_piece_start, other_piece_start),
        ),
    )
    return mask & ~suppress & start, doc_end_pos


def _nonzero_padded(mask, size: int, fill):
    """Small masks: one sort of (index where True, else N). ``torch.nonzero``
    would read its output's size back to the host."""
    N = mask.shape[0]
    idx = torch.arange(N, dtype=torch.int32, device=mask.device)
    keys = torch.sort(torch.where(mask, idx, N)).values[:size]
    if size > N:
        keys = torch.cat([keys, _full(size - N, N, keys)])
    return torch.where(keys < N, keys, fill)


def _row_stitch(m2, size: int):
    """Map every output slot p to (owning row, that row's first slot): the
    largest row r with rowstart[r] <= p, by a scan over scattered row marks.
    Returns (row_of, off_of, total)."""
    n_rows = m2.shape[0]
    dev = m2.device
    rowcount = m2.sum(dim=1, dtype=torch.int32)
    incl = torch.cumsum(rowcount, 0, dtype=torch.int32)  # tiny (n_rows)
    rowstart = incl - rowcount
    total = incl[n_rows - 1]
    # .at[rowstart].max(mode="drop"): slots past `size` go to a spare slot
    tgt = torch.clamp(rowstart, max=size).to(torch.int64)
    r_iota = torch.arange(n_rows, dtype=torch.int32, device=dev)
    marks_row = torch.full((size + 1,), -1, dtype=torch.int32, device=dev)
    marks_row.scatter_reduce_(0, tgt, r_iota, "amax")
    marks_off = torch.full((size + 1,), -1, dtype=torch.int32, device=dev)
    marks_off.scatter_reduce_(0, tgt, rowstart, "amax")
    row_of, off_of = scan.scan_leaves(
        [marks_row[:size], marks_off[:size]], ["max", "max"]
    )
    return row_of, off_of, total


def masked_positions(mask, size: int, fill):
    """Ascending indices of True positions, padded with ``fill`` (the
    counterpart of ``nonzero(mask, size=size, fill_value=fill)``).

    Each 128-bit row is compacted by a sort (True positions carry their
    index, False carry N), then every output slot reads its owning row's
    live prefix, found by one scan.
    """
    N = mask.shape[0]
    n_rows = N // 128
    if N % 128 or n_rows < 8:
        return _nonzero_padded(mask, size, fill)
    m2 = mask.reshape(n_rows, 128)
    idx2 = torch.arange(N, dtype=torch.int32, device=mask.device).reshape(n_rows, 128)
    rowdata = torch.sort(torch.where(m2, idx2, N), dim=1).values.reshape(-1)
    row_of, off_of, total = _row_stitch(m2, size)
    p = torch.arange(size, dtype=torch.int32, device=mask.device)
    out = take_clip(rowdata, row_of * 128 + (p - off_of))
    return torch.where(p < total, out, fill)


def masked_rows(mask, fields, size: int, fill):
    """Positions of True bits AND their field rows, in one stitch gather.

    Like :func:`masked_positions`, but the per-row sort carries the field
    columns along with the position key (sort the keys, then gather the
    fields with the sort's indices), so one row gather reads (pos, fields).
    Junk tail slots (key N) may come out in any order; only the live prefix
    (slots < popcount(mask)) is defined.

    Args:
      mask: bool[N]; fields: int32[N, F]; size: output capacity; fill:
        position fill for slots >= popcount(mask).

    Returns (pos int32[size], rows int32[size, F]); rows at dead slots are
    junk.
    """
    N = mask.shape[0]
    n_rows = N // 128
    if N % 128 or n_rows < 8:
        pos = _nonzero_padded(mask, size, fill)
        return pos, take_clip(fields, pos)
    F = fields.shape[1]
    m2 = mask.reshape(n_rows, 128)
    idx2 = torch.arange(N, dtype=torch.int32, device=mask.device).reshape(n_rows, 128)
    keys, order = torch.sort(torch.where(m2, idx2, N), dim=1)
    cols = [
        fields[:, j].reshape(n_rows, 128).gather(1, order) for j in range(F)
    ]
    comb = torch.stack([keys.reshape(-1)] + [c.reshape(-1) for c in cols], dim=1)
    row_of, off_of, total = _row_stitch(m2, size)
    p = torch.arange(size, dtype=torch.int32, device=mask.device)
    out = take_clip(comb, row_of * 128 + (p - off_of))  # [size, F+1]
    pos = torch.where(p < total, out[:, 0], fill)
    return pos, out[:, 1:]


def _word_probe(word_rows, word_mask, s1, s2, pw0, pw1, pw2, pw3, lens, short):
    """Exact whole-piece lookup: hit id or -1 per piece. ``word_rows`` is
    the pair of [S, 8] cuckoo half tables (w0..w3, len<<20|id, pad)."""

    def check(r):
        lenid = r[:, 4]
        ok = (
            (r[:, 0] == pw0) & (r[:, 1] == pw1) & (r[:, 2] == pw2)
            & (r[:, 3] == pw3) & (lenid >> 20 == lens) & (lenid >= 0)
        )
        return torch.where(ok, lenid & 0xFFFFF, -1)

    half0, half1 = word_rows
    S = word_mask + 1
    h1 = check(take_clip(half0, s1))
    h2 = check(take_clip(half1, s2 - S))
    hit = torch.where(h1 < 0, h2, h1)
    return torch.where(short, hit, -1)


class PieceTableV4(NamedTuple):
    """Stage-A output; all on the device."""

    starts: torch.Tensor        # int32[P]
    lens: torch.Tensor          # int32[P]
    hit: torch.Tensor           # int32[P] direct-hit token id or -1
    miss_sorted: torch.Tensor   # int32[M] piece indices, grouped by bucket
    group_start: torch.Tensor   # int32[len(BUCKET_WIDTHS)+1]
    n_pieces: torch.Tensor      # int32 scalar
    bucket_counts: torch.Tensor  # int32[len(BUCKET_WIDTHS)]
    overflow: torch.Tensor      # int32 scalar (bit flags)


def doc_token_counts_v4(offsets, n_tokens, starts, doc_ends, n_pieces):
    """Per-document token counts from the piece-count prefix sums.

    Pieces are in stream order, so document k owns the piece range
    [searchsorted(starts, begin_k), searchsorted(starts, begin_{k+1})).
    """
    del n_tokens
    D = doc_ends.shape[0]
    P = starts.shape[0]
    # doc k begins one past the previous doc's end (the separator byte)
    begins = torch.cat([doc_ends.new_zeros(1), doc_ends[: D - 1] + 1])
    first_piece = torch.searchsorted(starts, begins, side="left").to(torch.int32)
    live = torch.clamp(n_pieces, max=P)
    first_piece = torch.minimum(first_piece, live)
    bound = torch.cat([first_piece[1:], live.reshape(1)])
    counts = offsets.index_select(0, bound) - offsets.index_select(0, first_piece)
    return counts.clamp_min(0)


def _word_at(ext: torch.Tensor, k: int, N: int) -> torch.Tensor:
    """Little-endian int32 word of bytes [i+k, i+k+4) at every i."""
    return _i32(
        ext[k : N + k] | (ext[k + 1 : N + k + 1] << 8)
        | (ext[k + 2 : N + k + 2] << 16) | (ext[k + 3 : N + k + 3] << 24)
    )


def stage_a_v4(
    buf, doc_ends, class_table, pattern, word_rows, word_mask,
    *, variant: str, piece_div: int, miss_div: int,
):
    """Classify -> boundaries -> piece table -> word-table hits -> miss groups.

    Args:
      buf: uint8[N] chunk bytes (documents joined by separator bytes).
      doc_ends: int32[D] end position per chunk-document, padded with the
        used length; separators sit at doc_ends[k] for k < D-1 where
        doc_ends[k] < doc_ends[D-1].
      class_table: packed codepoint classes (unused for "ascii").
      word_rows: the two word-table half tensors.
      variant: "ascii" (arithmetic classes) or "unicode" (table lookup).
      piece_div / miss_div: capacity divisors (P = N // piece_div).

    Returns (PieceTableV4, meta int32[META_LEN]) with meta =
    [overflow_bits, n_pieces, bucket_counts...].
    """
    N = buf.shape[0]
    D = doc_ends.shape[0]
    dev = buf.device
    idx = torch.arange(N, dtype=torch.int32, device=dev)
    P = N // piece_div
    M = N // miss_div

    used = doc_ends[D - 1]
    # .at[sep_pos].set(True, mode="drop"): position N is the spare slot
    sep_pos = torch.where(doc_ends[: D - 1] < used, doc_ends[: D - 1], N)
    is_sep = torch.zeros(N + 1, dtype=torch.bool, device=dev)
    # index_fill_, not is_sep[...] = True: that copies its scalar from the host
    is_sep.index_fill_(0, sep_pos.to(torch.int64), True)
    valid = (idx < used) & ~is_sep[:N]

    if variant == "ascii":
        info = classify_ascii(buf, valid)
    else:
        info = classify_ops.classify_bytes(buf, class_table, valid)

    mask, doc_end_pos = piece_starts_v4(
        info, pattern, ascii_chars=(variant == "ascii")
    )

    n_pieces = mask.sum(dtype=torch.int32)
    p_iota = torch.arange(P, dtype=torch.int32, device=dev)

    # the piece positions AND their fields come out of ONE stitch gather;
    # four packed words cover the 16-byte direct-hit window
    ext = torch.cat([buf.to(torch.int64), torch.zeros(15, dtype=torch.int64, device=dev)])
    fields = torch.stack(
        [_word_at(ext, 0, N), _word_at(ext, 4, N), _word_at(ext, 8, N),
         _word_at(ext, 12, N), doc_end_pos],
        dim=1,
    )  # [N, 5]
    starts, frow = masked_rows(mask, fields, P, N)
    piece_valid = p_iota < torch.clamp(n_pieces, max=P)
    pw0_raw, pw1_raw, pw2_raw, pw3_raw, dend = frow.unbind(1)

    next_start = torch.cat([starts[1:], starts.new_full((1,), N)])
    ends = torch.minimum(next_start, dend)
    lens = torch.where(piece_valid, ends - starts, 0).to(torch.int32)

    overflow = torch.where(n_pieces > P, OVERFLOW_CAPACITY, 0) | torch.where(
        lens.max() > MAX_PIECE_LEN, OVERFLOW_PIECE_LEN, 0
    )

    # word-table probe (whole tokens of 1..16 bytes): mask the padded words
    # by length, hash (mirrors vocab.tables.word_key), probe both halves
    def lmask(lo):
        sh = (torch.clamp(lens - lo, 0, 4) * 8).to(torch.int64)
        return torch.where(sh >= 32, _M32, (1 << sh) - 1)

    pw0 = _i32(_u32(pw0_raw) & lmask(0))
    pw1 = _i32(_u32(pw1_raw) & lmask(4))
    pw2 = _i32(_u32(pw2_raw) & lmask(8))
    pw3 = _i32(_u32(pw3_raw) & lmask(12))

    short = piece_valid & (lens >= 1) & (lens <= 16)
    hu = _u32(pw0) ^ ((_u32(pw2) * _W2_MIX) & _M32)
    hv = (
        _u32(pw1) ^ ((_u32(lens) * _LEN_MIX) & _M32)
        ^ ((_u32(pw3) * _W3_MIX) & _M32)
    )
    hu, hv = _i32(hu), _i32(hv)
    s1 = _mix(hu, hv, _H1, word_mask)
    s2 = _mix(hu, hv, _H2, word_mask) + (word_mask + 1)
    hit = _word_probe(
        word_rows, word_mask, s1, s2, pw0, pw1, pw2, pw3, lens, short
    )

    # compact misses, grouped by length bucket (stable: stream order kept)
    miss = piece_valid & (hit < 0)
    n_miss = miss.sum(dtype=torch.int32)
    overflow = overflow | torch.where(n_miss > M, OVERFLOW_CAPACITY, 0)
    miss_idx = masked_positions(miss, M, P - 1)
    m_valid = torch.arange(M, dtype=torch.int32, device=dev) < torch.clamp(n_miss, max=M)
    m_len = torch.where(m_valid, take_clip(lens, miss_idx), 0)
    bucket_of = torch.zeros_like(m_len)
    for w in BUCKET_WIDTHS[:-1]:
        bucket_of = bucket_of + (m_len > w).to(torch.int32)
    nb = len(BUCKET_WIDTHS)
    bucket_of = torch.where(m_valid, bucket_of, nb)
    order = torch.argsort(bucket_of, stable=True)
    miss_sorted = miss_idx.index_select(0, order)
    # bincount(length=nb+1) as a scatter-add: no host sync for the size
    bucket_counts = torch.zeros(nb + 1, dtype=torch.int32, device=dev).scatter_add_(
        0, bucket_of.to(torch.int64), torch.ones_like(bucket_of)
    )[:nb]
    group_start = torch.cat([
        bucket_counts.new_zeros(1), torch.cumsum(bucket_counts, 0, dtype=torch.int32)
    ])

    overflow = overflow.to(torch.int32)
    meta = torch.cat(
        [overflow.reshape(1), n_pieces.reshape(1), bucket_counts]
    ).to(torch.int32)
    return PieceTableV4(
        starts, lens, hit, miss_sorted, group_start,
        n_pieces, bucket_counts, overflow,
    ), meta
