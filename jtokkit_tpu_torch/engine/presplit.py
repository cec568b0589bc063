"""Host-side pre-split scanners with exact Java-regex semantics.

The reference pre-splits text with two patterns compiled under
``Pattern.UNICODE_CHARACTER_CLASS`` (reference ``M/EncodingFactory.java:63,105,129``):

GPT-2 pattern (r50k_base / p50k_base / p50k_edit)::

    's|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+

cl100k_base pattern::

    (?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\\r\\n\\p{L}\\p{N}]?\\p{L}+|\\p{N}{1,3}| ?[^\\s\\p{L}\\p{N}]+[\\r\\n]*|\\s*[\\r\\n]+|\\s+(?!\\S)|\\s+

Instead of delegating to a regex engine (Python's ``re``/``regex`` disagree with
Java on the ``\\s`` class and backtracking corners), both patterns are
implemented directly as hand-rolled scanners. Alternation is ordered
(first-match-wins at each position, like ``Matcher.find`` with every position
matching some alternative, so pieces tile the input exactly). The non-obvious
backtracking cases are spelled out inline.

These scanners are the correctness oracle for the vectorized device pre-split
(`jtokkit_tpu_torch/ops/stage4.py`) and are validated against the reference's
conformance CSVs.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

from .charclass import CRLF, LETTER, NUMBER, OTHER, SPACE, WS, classify

_APOSTROPHE = 0x27

# Contraction suffixes, in the order they appear in the alternation.
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")


def _cls(text: str, i: int) -> int:
    return classify(ord(text[i]))


def _is_ws(c: int) -> bool:
    return c >= WS  # WS, CRLF, SPACE


def _match_contraction(text: str, i: int, n: int, ignore_case: bool) -> int:
    """Length of a contraction match starting at ``i`` (0 if none)."""
    if ord(text[i]) != _APOSTROPHE:
        return 0
    for suffix in _CONTRACTIONS:
        end = i + 1 + len(suffix)
        if end > n:
            continue
        got = text[i + 1 : end]
        if ignore_case:
            # (?i:...) under Java's UNICODE_CASE (implied by
            # UNICODE_CHARACTER_CLASS). Java folds each char via
            # toLowerCase(toUpperCase(c)); for the suffix letters
            # {s,t,r,e,v,m,l,d} the only non-ASCII equivalence is
            # U+017F LONG S ≡ 's', which str.casefold() also maps.
            got = got.casefold()
        if got == suffix:
            return 1 + len(suffix)
    return 0


def _run(text: str, i: int, n: int, want) -> int:
    """End of the maximal run starting at ``i`` whose classes satisfy ``want``."""
    j = i
    while j < n and want(_cls(text, j)):
        j += 1
    return j


def split_gpt2(text: str) -> Iterator[Tuple[int, int]]:
    """Yield (start, end) piece spans of the GPT-2 pre-split pattern.

    Mirrors ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``
    (reference ``M/EncodingFactory.java:63``) with ordered alternation.
    """
    n = len(text)
    i = 0
    while i < n:
        c = _cls(text, i)

        # 1) case-sensitive contractions
        if c == OTHER:
            clen = _match_contraction(text, i, n, ignore_case=False)
            if clen:
                yield (i, i + clen)
                i += clen
                continue
            # 4) [^\s\p{L}\p{N}]+  (no leading space at this position)
            j = _run(text, i + 1, n, lambda k: k == OTHER)
            yield (i, j)
            i = j
            continue

        if c == LETTER:  # 2) \p{L}+
            j = _run(text, i + 1, n, lambda k: k == LETTER)
            yield (i, j)
            i = j
            continue

        if c == NUMBER:  # 3) \p{N}+
            j = _run(text, i + 1, n, lambda k: k == NUMBER)
            yield (i, j)
            i = j
            continue

        # Whitespace. A single SPACE may glue onto a following letter/number/
        # other run (" ?X+" alternatives are tried before the \s ones).
        if c == SPACE and i + 1 < n:
            nxt = _cls(text, i + 1)
            if nxt == LETTER:
                j = _run(text, i + 2, n, lambda k: k == LETTER)
                yield (i, j)
                i = j
                continue
            if nxt == NUMBER:
                j = _run(text, i + 2, n, lambda k: k == NUMBER)
                yield (i, j)
                i = j
                continue
            if nxt == OTHER:
                j = _run(text, i + 2, n, lambda k: k == OTHER)
                yield (i, j)
                i = j
                continue

        # 5) \s+(?!\S)  |  6) \s+
        j = _run(text, i + 1, n, _is_ws)
        if j == n:
            # \s+ greedy, lookahead (?!\S) succeeds at end of input
            yield (i, j)
            i = j
        elif j - i > 1:
            # lookahead fails on the full run; backtrack one char so the last
            # whitespace char can start the next piece (e.g. " word")
            yield (i, j - 1)
            i = j - 1
        else:
            # single whitespace char followed by \S: alternative 5 fails
            # entirely, alternative 6 (\s+) takes the single char
            yield (i, j)
            i = j
    return


def split_cl100k(text: str) -> Iterator[Tuple[int, int]]:
    """Yield (start, end) piece spans of the cl100k_base pre-split pattern.

    Mirrors ``(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\\r\\n\\p{L}\\p{N}]?\\p{L}+|\\p{N}{1,3}| ?[^\\s\\p{L}\\p{N}]+[\\r\\n]*|\\s*[\\r\\n]+|\\s+(?!\\S)|\\s+``
    (reference ``M/EncodingFactory.java:105``) with ordered alternation.
    """
    n = len(text)
    i = 0
    while i < n:
        c = _cls(text, i)

        # 1) case-insensitive contractions
        if c == OTHER:
            clen = _match_contraction(text, i, n, ignore_case=True)
            if clen:
                yield (i, i + clen)
                i += clen
                continue

        # 2) [^\r\n\p{L}\p{N}]?\p{L}+ — optional one-char prefix (anything but
        # CR/LF/letter/number, including non-CRLF whitespace), then letters.
        if c == LETTER:
            j = _run(text, i + 1, n, lambda k: k == LETTER)
            yield (i, j)
            i = j
            continue
        if c not in (CRLF, NUMBER) and i + 1 < n and _cls(text, i + 1) == LETTER:
            j = _run(text, i + 2, n, lambda k: k == LETTER)
            yield (i, j)
            i = j
            continue

        # 3) \p{N}{1,3} — digits in groups of at most three
        if c == NUMBER:
            j = i + 1
            while j < n and j - i < 3 and _cls(text, j) == NUMBER:
                j += 1
            yield (i, j)
            i = j
            continue

        # 4)  ?[^\s\p{L}\p{N}]+[\r\n]* — punctuation run with optional leading
        # space and trailing CR/LF run
        if c == OTHER or (c == SPACE and i + 1 < n and _cls(text, i + 1) == OTHER):
            j = _run(text, i + 1 if c == OTHER else i + 2, n, lambda k: k == OTHER)
            j = _run(text, j, n, lambda k: k == CRLF)
            yield (i, j)
            i = j
            continue

        # Whitespace-only alternatives. c is whitespace here (OTHER handled
        # above; SPACE followed by OTHER handled above; SPACE followed by
        # LETTER handled by alternative 2).
        j = _run(text, i + 1, n, _is_ws)
        # 5) \s*[\r\n]+ — backtracking yields: match through the LAST CR/LF
        # char of the maximal whitespace run, if the run contains any.
        last_crlf = -1
        for k in range(j - 1, i - 1, -1):
            if _cls(text, k) == CRLF:
                last_crlf = k
                break
        if last_crlf >= 0:
            yield (i, last_crlf + 1)
            i = last_crlf + 1
            continue
        # 6) \s+(?!\S)  |  7) \s+   (run contains no CR/LF here)
        if j == n:
            yield (i, j)
            i = j
        elif j - i > 1:
            yield (i, j - 1)
            i = j - 1
        else:
            yield (i, j)
            i = j
    return


_SPLITTERS = {
    "gpt2": split_gpt2,
    "cl100k": split_cl100k,
}

BUILTIN_PATTERNS = frozenset(_SPLITTERS)


def compile_splitter(pattern: str):
    """Splitter callable for a pattern spec.

    Built-in families ("gpt2", "cl100k") use the hand-rolled scanners above.
    Any other string is treated as a regex for custom encodings (reference
    extension point ``M/api/EncodingRegistry.java:58-67``) and compiled with
    the ``regex`` module; like ``Matcher.find``, unmatched characters are
    skipped.
    """
    if pattern in _SPLITTERS:
        return _SPLITTERS[pattern]
    import regex as _regex

    rx = _regex.compile(pattern)

    def _custom_split(text: str) -> Iterator[Tuple[int, int]]:
        for m in rx.finditer(text):
            if m.end() > m.start():
                yield (m.start(), m.end())

    return _custom_split


def split(text: str, pattern: str) -> List[Tuple[int, int]]:
    """Piece spans for ``pattern`` (built-in family or custom regex)."""
    return list(compile_splitter(pattern)(text))


def split_pieces(text: str, pattern: str) -> List[str]:
    return [text[a:b] for a, b in _SPLITTERS[pattern](text)]
