"""Unicode character classes for the tiktoken pre-split patterns.

The reference compiles its pre-split regexes with Java's
``Pattern.UNICODE_CHARACTER_CLASS`` (reference ``M/EncodingFactory.java:129``),
under which:

- ``\\p{L}`` = Unicode general category L* (Lu, Ll, Lt, Lm, Lo)
- ``\\p{N}`` = Unicode general category N* (Nd, Nl, No)
- ``\\s``    = the Unicode ``White_Space`` property (NOT Python's ``str.isspace``
  set, which additionally contains U+001C..U+001F)

We reduce every codepoint to one of six classes, chosen so that every decision
the pre-split scanners make is a function of (class, codepoint equality checks):

====  =========  =====================================================
code  name       meaning
====  =========  =====================================================
0     OTHER      not whitespace, not letter, not number ("punctuation")
1     LETTER     \\p{L}
2     NUMBER     \\p{N}
3     WS         White_Space, excluding SPACE/CR/LF
4     CRLF       U+000D CR or U+000A LF
5     SPACE      U+0020
====  =========  =====================================================

``\\s`` == class in {WS, CRLF, SPACE}.

The full 0x110000-entry class table (int8, ~1.1 MB) used by the device engine
is built once from :mod:`unicodedata` and cached as ``.npy`` next to the
package (see :func:`class_table`).
"""

from __future__ import annotations

import os
import sys
import unicodedata

import numpy as np

OTHER = 0
LETTER = 1
NUMBER = 2
WS = 3
CRLF = 4
SPACE = 5
PAD = 6  # device-only: padding bytes past the valid length

NUM_CLASSES = 6

_LETTER_CATS = frozenset(("Lu", "Ll", "Lt", "Lm", "Lo"))
_NUMBER_CATS = frozenset(("Nd", "Nl", "No"))

# Unicode White_Space property codepoints (PropList.txt). This matches Java's
# \s under UNICODE_CHARACTER_CLASS ("\p{IsWhite_Space}") and Rust regex's \s,
# but NOT Python re's \s (which adds U+001C..1F).
WHITE_SPACE = frozenset(
    list(range(0x09, 0x0E))  # TAB LF VT FF CR
    + [0x20, 0x85, 0xA0, 0x1680]
    + list(range(0x2000, 0x200B))
    + [0x2028, 0x2029, 0x202F, 0x205F, 0x3000]
)

MAX_CODEPOINT = 0x110000


def classify(cp: int) -> int:
    """Class of a single codepoint (host-side scalar path)."""
    if cp == 0x20:
        return SPACE
    if cp == 0x0A or cp == 0x0D:
        return CRLF
    if cp in WHITE_SPACE:
        return WS
    cat = unicodedata.category(chr(cp))
    if cat in _LETTER_CATS:
        return LETTER
    if cat in _NUMBER_CATS:
        return NUMBER
    return OTHER


def _build_class_table() -> np.ndarray:
    table = np.zeros(MAX_CODEPOINT, dtype=np.int8)
    category = unicodedata.category
    letter_cats = _LETTER_CATS
    number_cats = _NUMBER_CATS
    for cp in range(MAX_CODEPOINT):
        cat = category(chr(cp))
        if cat in letter_cats:
            table[cp] = LETTER
        elif cat in number_cats:
            table[cp] = NUMBER
    for cp in WHITE_SPACE:
        table[cp] = WS
    table[0x0A] = CRLF
    table[0x0D] = CRLF
    table[0x20] = SPACE
    return table


_CLASS_TABLE: np.ndarray | None = None


def _cache_path() -> str:
    udv = unicodedata.unidata_version.replace(".", "_")
    return os.path.join(
        os.path.dirname(__file__), f"_charclass_u{udv}.npy"
    )


def class_table() -> np.ndarray:
    """Full int8 class table over all codepoints, cached on disk."""
    global _CLASS_TABLE
    if _CLASS_TABLE is not None:
        return _CLASS_TABLE
    path = _cache_path()
    if os.path.exists(path):
        try:
            table = np.load(path)
            if table.shape == (MAX_CODEPOINT,) and table.dtype == np.int8:
                _CLASS_TABLE = table
                return table
        except Exception:  # corrupt cache: rebuild
            pass
    table = _build_class_table()
    try:
        # stale tmp files from crashed writers (and from a historical bug
        # where np.save appended .npy to the tmp name, breaking os.replace)
        base = os.path.basename(path)
        d = os.path.dirname(path)
        for f in os.listdir(d):
            if f.startswith(f"{base}.tmp."):
                try:
                    os.remove(os.path.join(d, f))
                except OSError:
                    pass
        # np.save appends .npy unless the name already ends with it, so
        # write through an open file handle to keep the tmp name exact
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as fh:
            np.save(fh, table)
        os.replace(tmp, path)
    except OSError:
        pass  # read-only install: keep in memory only
    _CLASS_TABLE = table
    return table


def is_whitespace(cls: int) -> bool:
    return cls >= WS  # WS, CRLF, SPACE


def is_letter(cls: int) -> bool:
    return cls == LETTER


def is_number(cls: int) -> bool:
    return cls == NUMBER
