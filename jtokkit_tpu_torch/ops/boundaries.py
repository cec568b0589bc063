"""Piece boundaries of a classified byte stream, one prefix scan per
run-level quantity.

Counterpart of ``jtokkit_tpu/ops/boundaries.py``. The engine's long-piece
fallback runs this formulation (Stage A runs the fused
:func:`..ops.stage4.piece_starts_v4`). The two pre-split patterns
(reference ``M/EncodingFactory.java:63,105``) are decomposed into closed-form
per-character rules over the byte stream:

- class runs (letters / numbers / punctuation) continue purely by class;
- whitespace runs need run-level analysis (the ``\\s+(?!\\S)`` backtrack
  splits off the last whitespace char; ``\\s*[\\r\\n]+`` matches through the
  run's last CR/LF; punctuation absorbs a following CR/LF run in cl100k);
- a trailing space (cl100k: any non-CRLF whitespace before letters; one
  OTHER char before letters) glues onto the following run;
- contractions fire only at apostrophes that start a piece, with at most two
  chars of lookahead (cl100k case-insensitively under Unicode simple
  folding, which adds U+017F LONG S for 's');
- cl100k digit runs split into groups of three codepoints from the run
  start.

Every running maximum goes through :func:`..ops.scan.scan_leaves` (the
kernel on the card, the plain version on the CPU), and maxima that do not
depend on each other share one multi-leaf call: three calls per cl100k
stream, two for gpt2. The leaves hold a position or ordinal >= 0, or -1.

Returns a boolean piece-start mask over bytes; piece k spans
[start_k, start_{k+1}).
"""

from __future__ import annotations

import torch

from ..engine.charclass import CRLF, LETTER, NUMBER, OTHER, PAD, SPACE, WS
from . import scan
from .classify import take_clip

_BOS = -1  # sentinel class "before begin / after end"

_APO = 0x27
_ONE_CHAR = (ord("s"), ord("t"), ord("m"), ord("d"))
_TWO_CHAR = ((ord("r"), ord("e")), (ord("v"), ord("e")), (ord("l"), ord("l")))


def _cummax(*leaves):
    """Running maximum of each leaf, all in one scan call."""
    return scan.scan_leaves(list(leaves), ["max"] * len(leaves))


def _shift_right(x, fill, k: int = 1):
    """y[i] = x[i-k], y[:k] = fill."""
    head = torch.full((k,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([head, x])[: x.shape[0]]


def _gather(x, idx, fill, valid):
    """x[idx] where valid, else fill (idx clamped)."""
    return torch.where(valid, take_clip(x, idx), fill)


def piece_starts(info: dict, pattern: str) -> torch.Tensor:
    """Boolean piece-start mask for a classified byte stream.

    Args:
      info: output of :func:`..ops.classify.classify_bytes`.
      pattern: "gpt2" or "cl100k".

    Returns bool[n], True at the first byte of every piece.
    """
    if pattern not in ("gpt2", "cl100k"):
        raise ValueError(f"unsupported device pattern {pattern!r}")
    is_cl = pattern == "cl100k"

    cls = info["cls"]
    start = info["is_start"]
    byte = info["byte"]
    n = cls.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.bool, device=cls.device)
    idx = torch.arange(n, dtype=torch.int32, device=cls.device)

    prev_cls = _shift_right(cls, _BOS)
    # position of the char start covering byte i: UTF-8 chars are at most 4
    # bytes, so three shifted selects instead of a prefix scan
    s1 = _shift_right(start, False)
    s2 = _shift_right(s1, False)
    char_start_pos = torch.where(
        start, idx, torch.where(s1, idx - 1, torch.where(s2, idx - 2, idx - 3))
    )

    is_ws = (cls >= WS) & (cls <= SPACE)
    is_crlf_b = cls == CRLF  # CR/LF are single-byte chars

    # ---------------- whitespace run structure ----------------------------
    ws_run_start_b = is_ws & ~_shift_right(is_ws, False)
    # run end: distance to run start on the reversed array
    ws_rev = is_ws.flip(0)
    leaves = [
        torch.where(ws_run_start_b, idx, -1),
        torch.where(ws_rev & ~_shift_right(ws_rev, False), idx, -1),
    ]
    if is_cl:
        leaves.append(torch.where(~is_crlf_b, idx, -1))
    run_start_pos, run_end_rev, *rest = _cummax(*leaves)
    run_end_pos = (n - 1) - run_end_rev.flip(0)  # last byte of the ws run

    if is_cl:
        # cl100k: the CR/LF prefix of a ws run following punctuation is
        # absorbed into the punctuation piece (`[\r\n]*` of alternative 4)
        (last_non_crlf,) = rest
        in_crlf_prefix = is_crlf_b & (last_non_crlf < run_start_pos)
        prev_of_run = _gather(cls, run_start_pos - 1, _BOS, run_start_pos > 0)
        absorbed = in_crlf_prefix & (prev_of_run == OTHER)
        eff_ws = is_ws & ~absorbed
    else:
        eff_ws = is_ws

    eff_run_start_b = eff_ws & ~_shift_right(eff_ws, False)
    # per byte: last CR/LF position within the effective run, read at run end
    eff_run_start_pos, last_crlf_pos = _cummax(
        torch.where(eff_run_start_b, idx, -1),
        torch.where(is_crlf_b & eff_ws, idx, -1),
    )
    last_crlf_whole = _gather(last_crlf_pos, run_end_pos, -1, is_ws)
    next_after_run = _gather(cls, run_end_pos + 1, _BOS, (run_end_pos + 1) < n)
    # PAD past the valid length behaves like end-of-input for the trailing-
    # whitespace rules (the (?!\S) lookahead succeeds at the end)
    followed_by_nonws = ((run_end_pos + 1) < n) & (next_after_run != PAD)
    last_char_start = _gather(char_start_pos, run_end_pos, -1, is_ws)

    if is_cl:
        crlf_present = last_crlf_whole >= eff_run_start_pos
        # sub-run where the trailing (\s+(?!\S) / glue) rules apply
        sub_start = torch.where(crlf_present, last_crlf_whole + 1, eff_run_start_pos)
        has_remainder = sub_start <= run_end_pos
        ws_piece_start = eff_ws & start & (
            (idx == eff_run_start_pos)
            | (crlf_present & has_remainder & (idx == sub_start))
            | (followed_by_nonws & has_remainder & (idx == last_char_start)
               & (idx != sub_start))
        )
        # glue of the run's last char onto the following run:
        #   next LETTER  -> any non-CRLF ws glues (alt-2 one-char prefix)
        #   next OTHER   -> only a literal space glues (alt-4 " ?")
        #   next NUMBER  -> never (\p{N}{1,3} has no prefix)
        glue_ok = (next_after_run == LETTER) | (
            (next_after_run == OTHER) & (byte == 0x20)
        )
        glue_fwd = (
            eff_ws & start & followed_by_nonws & has_remainder
            & (idx == last_char_start) & glue_ok
        )
    else:
        ws_piece_start = is_ws & start & (
            (idx == run_start_pos)
            | (followed_by_nonws & (idx == last_char_start)
               & (idx != run_start_pos))
        )
        # GPT-2: only a literal space glues, onto any non-ws run
        glue_fwd = (
            is_ws & start & followed_by_nonws
            & (idx == last_char_start) & (byte == 0x20)
        )

    # glued_back: the previous char carries glue_fwd
    prev_char = _gather(char_start_pos, idx - 1, -1, idx > 0)
    glued_back = _gather(glue_fwd, prev_char, False, prev_char >= 0)

    # ---------------- punctuation (OTHER) runs -----------------------------
    other_piece_start = start & (cls == OTHER) & (prev_cls != OTHER) & ~glued_back

    # ---------------- contractions -----------------------------------------
    b1 = _gather(byte, idx + 1, 0, idx + 1 < n)
    b2 = _gather(byte, idx + 2, 0, idx + 2 < n)
    one = torch.zeros_like(start)
    two = torch.zeros_like(start)
    if is_cl:
        l1 = torch.where((b1 >= 65) & (b1 <= 90), b1 + 32, b1)  # ASCII fold
        l2 = torch.where((b2 >= 65) & (b2 <= 90), b2 + 32, b2)
        for c in _ONE_CHAR:
            one = one | (l1 == c)
        for c1, c2 in _TWO_CHAR:
            two = two | ((l1 == c1) & (l2 == c2))
        # U+017F LATIN SMALL LETTER LONG S simple-case-folds to 's' under
        # Java's UNICODE_CASE: "'ſ" is a contraction. UTF-8: C5 BF.
        long_s = (b1 == 0xC5) & (b2 == 0xBF)
    else:
        for c in _ONE_CHAR:
            one = one | (b1 == c)
        for c1, c2 in _TWO_CHAR:
            two = two | ((b1 == c1) & (b2 == c2))
        long_s = torch.zeros_like(start)

    apo_start = (byte == _APO) & other_piece_start
    contraction2 = apo_start & one  # spans 2 bytes: ' + ascii letter
    contraction3 = apo_start & ~one & (two | long_s)  # spans 3 bytes
    contraction = contraction2 | contraction3

    # suffix bytes of a contraction never start a piece
    suppress = _shift_right(contraction, False) | _shift_right(contraction3, False, 2)
    # the char right after a contraction always starts a piece
    forced = _shift_right(contraction2, False, 2) | _shift_right(contraction3, False, 3)

    # ---------------- letter runs ------------------------------------------
    if is_cl:
        # one OTHER char that starts a piece (and is no contraction) prefixes
        # a following letter run (alt-2 `[^\r\n\p{L}\p{N}]?`)
        prev_is_prefix = _gather(
            other_piece_start & ~contraction, prev_char, False, prev_char >= 0
        ) & (prev_cls == OTHER)
        letter_glued = glued_back | prev_is_prefix
    else:
        letter_glued = glued_back
    letter_piece_start = start & (cls == LETTER) & (
        ((prev_cls != LETTER) & ~letter_glued) | forced
    )

    # ---------------- number runs ------------------------------------------
    if is_cl:
        char_ord = torch.cumsum(start, 0, dtype=torch.int32) - 1
        digit_run_start = start & (cls == NUMBER) & (prev_cls != NUMBER)
        (run_start_ord,) = _cummax(torch.where(digit_run_start, char_ord, -1))
        pos_in_run = char_ord - run_start_ord
        number_piece_start = start & (cls == NUMBER) & (pos_in_run % 3 == 0)
    else:
        number_piece_start = start & (cls == NUMBER) & (
            (prev_cls != NUMBER) & ~glued_back
        )

    piece_start = torch.where(
        is_ws,
        ws_piece_start,
        torch.where(
            cls == LETTER,
            letter_piece_start,
            torch.where(cls == NUMBER, number_piece_start, other_piece_start),
        ),
    )
    return piece_start & ~suppress & start
