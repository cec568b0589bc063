"""The two pre-split patterns of the built-in encodings, as plain scanners.

A frozen copy of the port's host scanners, kept here so that later changes
to the program cannot move the yardstick. Both patterns are compiled by the
original library with Java's ``UNICODE_CHARACTER_CLASS``:

GPT-2 (r50k_base, p50k_base, p50k_edit)::

    's|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+

cl100k_base::

    (?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\\r\\n\\p{L}\\p{N}]?\\p{L}+|\\p{N}{1,3}| ?[^\\s\\p{L}\\p{N}]+[\\r\\n]*|\\s*[\\r\\n]+|\\s+(?!\\S)|\\s+

Alternation is ordered (first match wins at each position) and the pieces
tile the text. ``\\p{L}`` is Unicode category L*, ``\\p{N}`` category N*,
``\\s`` the White_Space property (not Python's ``str.isspace``, which adds
U+001C..U+001F).
"""

from __future__ import annotations

import unicodedata
from typing import Iterator, List, Tuple

OTHER, LETTER, NUMBER, WS, CRLF, SPACE = range(6)

WHITE_SPACE = frozenset(
    list(range(0x09, 0x0E)) + [0x20, 0x85, 0xA0, 0x1680]
    + list(range(0x2000, 0x200B)) + [0x2028, 0x2029, 0x202F, 0x205F, 0x3000]
)
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")


def classify(ch: str) -> int:
    cp = ord(ch)
    if cp == 0x20:
        return SPACE
    if cp in (0x0A, 0x0D):
        return CRLF
    if cp in WHITE_SPACE:
        return WS
    cat = unicodedata.category(ch)
    if cat[0] == "L":
        return LETTER
    if cat[0] == "N":
        return NUMBER
    return OTHER


class _Classes(dict):
    def __missing__(self, ch):
        c = self[ch] = classify(ch)
        return c


_CLASSES = _Classes()


def classes(text: str) -> List[int]:
    """The class of every character of ``text``."""
    get = _CLASSES.__getitem__
    return [get(ch) for ch in text]


def _contraction(text: str, i: int, n: int, ignore_case: bool) -> int:
    if text[i] != "'":
        return 0
    for suffix in _CONTRACTIONS:
        end = i + 1 + len(suffix)
        if end > n:
            continue
        got = text[i + 1:end]
        if ignore_case:
            # Java folds under UNICODE_CASE; for these letters the only
            # non-ASCII equivalent is U+017F LONG S, which casefold maps too
            got = got.casefold()
        if got == suffix:
            return 1 + len(suffix)
    return 0


def _run(cls: List[int], i: int, n: int, want) -> int:
    while i < n and cls[i] in want:
        i += 1
    return i


_L, _N, _O, _S, _C = {LETTER}, {NUMBER}, {OTHER}, {WS, CRLF, SPACE}, {CRLF}


def split_gpt2(text: str) -> Iterator[Tuple[int, int]]:
    """(start, end) of every piece of the GPT-2 pattern."""
    cls = classes(text)
    n = len(text)
    i = 0
    while i < n:
        c = cls[i]
        if c == OTHER:
            k = _contraction(text, i, n, False)
            if k:
                yield i, i + k
                i += k
                continue
            j = _run(cls, i + 1, n, _O)
        elif c == LETTER:
            j = _run(cls, i + 1, n, _L)
        elif c == NUMBER:
            j = _run(cls, i + 1, n, _N)
        elif c == SPACE and i + 1 < n and cls[i + 1] in (LETTER, NUMBER, OTHER):
            want = {LETTER: _L, NUMBER: _N, OTHER: _O}[cls[i + 1]]
            j = _run(cls, i + 2, n, want)
        else:
            # \s+(?!\S) backtracks one character before a non-space; \s+
            # takes a single one
            j = _run(cls, i + 1, n, _S)
            if j < n and j - i > 1:
                j -= 1
        yield i, j
        i = j


def split_cl100k(text: str) -> Iterator[Tuple[int, int]]:
    """(start, end) of every piece of the cl100k_base pattern."""
    cls = classes(text)
    n = len(text)
    i = 0
    while i < n:
        c = cls[i]
        if c == OTHER:
            k = _contraction(text, i, n, True)
            if k:
                yield i, i + k
                i += k
                continue
        if c == LETTER:
            j = _run(cls, i + 1, n, _L)
        elif c not in (CRLF, NUMBER) and i + 1 < n and cls[i + 1] == LETTER:
            # [^\r\n\p{L}\p{N}]?\p{L}+
            j = _run(cls, i + 2, n, _L)
        elif c == NUMBER:
            j = i + 1
            while j < n and j - i < 3 and cls[j] == NUMBER:
                j += 1
        elif c == OTHER or (c == SPACE and i + 1 < n and cls[i + 1] == OTHER):
            # ' ?[^\s\p{L}\p{N}]+[\r\n]*'
            j = _run(cls, i + 1 if c == OTHER else i + 2, n, _O)
            j = _run(cls, j, n, _C)
        else:
            j = _run(cls, i + 1, n, _S)
            last = -1
            for k in range(j - 1, i - 1, -1):
                if cls[k] == CRLF:
                    last = k
                    break
            if last >= 0:
                # \s*[\r\n]+ ends at the run's last CR or LF
                j = last + 1
            elif j < n and j - i > 1:
                j -= 1
        yield i, j
        i = j


SPLITTERS = {"gpt2": split_gpt2, "cl100k": split_cl100k}
