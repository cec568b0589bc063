"""Vectorized UTF-8 decode and character classification on the device.

Counterpart of ``jtokkit_tpu/ops/classify.py`` plus ``classify_ascii`` from
``jtokkit_tpu/ops/stage4.py``. Every byte is classified in parallel:

- decode the codepoint starting at each lead byte with shifted-mask
  arithmetic,
- look its class up in the codepoint table built by
  :mod:`jtokkit_tpu_torch.engine.charclass` (packed 10 classes per int32),
- propagate the class to continuation bytes, so later boundary logic reads
  "class of the character containing byte i" with plain shifts.

Inputs are valid UTF-8 (they come from encoding Python strings).
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine import charclass

OTHER = charclass.OTHER
LETTER = charclass.LETTER
NUMBER = charclass.NUMBER
WS = charclass.WS
CRLF = charclass.CRLF
SPACE = charclass.SPACE
PAD = charclass.PAD

# Classes are 3 bits; 10 fit one int32 word.
_PACK_PER_WORD = 10


def packed_class_table_array() -> np.ndarray:
    """The codepoint->class table packed 10 classes per int32 word."""
    t = charclass.class_table().astype(np.int64)
    n = t.shape[0]
    rows = -(-n // _PACK_PER_WORD)
    padded = np.zeros(rows * _PACK_PER_WORD, np.int64)
    padded[:n] = t
    packed = np.zeros(rows, np.int64)
    for k in range(_PACK_PER_WORD):
        packed |= padded[k::_PACK_PER_WORD] << (3 * k)
    return packed.astype(np.int32)


def take_clip(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` along dim 0 with indices clamped into range (the
    counterpart of ``jnp.take(..., mode="clip")``)."""
    flat = idx.reshape(-1).clamp(0, table.shape[0] - 1)
    return table.index_select(0, flat).reshape(*idx.shape, *table.shape[1:])


def _class_lookup(class_table: torch.Tensor, cp: torch.Tensor) -> torch.Tensor:
    """Class of each codepoint from the packed int32 table."""
    w = take_clip(class_table, cp // _PACK_PER_WORD)
    sh = (cp % _PACK_PER_WORD) * 3
    return (w >> sh) & 7


def _shift_r(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    return torch.cat([torch.full((k,), fill, dtype=x.dtype, device=x.device), x[:-k]])


def decode_utf8(data: torch.Tensor):
    """Per-byte UTF-8 structure of a uint8[n] stream.

    Returns (codepoint int32[n], is_start bool[n], char_len int32[n]),
    valid at lead bytes; arbitrary at continuation bytes.
    """
    b0 = data.to(torch.int32)
    n = data.shape[0]
    ext = torch.cat([b0, torch.zeros(3, dtype=torch.int32, device=data.device)])
    b1, b2, b3 = ext[1 : n + 1], ext[2 : n + 2], ext[3 : n + 3]

    is_start = (b0 & 0xC0) != 0x80

    len1 = b0 < 0x80
    len2 = (b0 & 0xE0) == 0xC0
    len3 = (b0 & 0xF0) == 0xE0
    char_len = torch.where(
        len1, 1, torch.where(len2, 2, torch.where(len3, 3, 4))
    ).to(torch.int32)

    cp2 = ((b0 & 0x1F) << 6) | (b1 & 0x3F)
    cp3 = ((b0 & 0x0F) << 12) | ((b1 & 0x3F) << 6) | (b2 & 0x3F)
    cp4 = (
        ((b0 & 0x07) << 18) | ((b1 & 0x3F) << 12) | ((b2 & 0x3F) << 6)
        | (b3 & 0x3F)
    )
    cp = torch.where(len1, b0, torch.where(len2, cp2, torch.where(len3, cp3, cp4)))
    return cp, is_start, char_len


def classify_bytes(data: torch.Tensor, class_table: torch.Tensor, valid=None):
    """Per-byte char structure with classes propagated to continuations.

    Args:
      data: uint8[n] byte stream.
      class_table: the packed codepoint->class table on the device.
      valid: optional bool[n] mask; bytes where it is False (past the end,
        document separators) get class PAD and are never char starts.

    Returns a dict of int32[n] / bool[n] tensors: ``cls``, ``cls_start``,
    ``is_start``, ``char_len``, ``byte``.
    """
    cp, is_start, char_len = decode_utf8(data)
    cls_start = _class_lookup(
        class_table, cp.clamp(0, charclass.MAX_CODEPOINT - 1)
    )
    if valid is not None:
        is_start = is_start & valid
        cls_start = torch.where(valid, cls_start, PAD)

    # a UTF-8 char is at most 4 bytes: a bounded select over 3 shifted
    # copies propagates the lead byte's class
    s1 = _shift_r(is_start, 1, False)
    s2 = _shift_r(is_start, 2, False)
    c1 = _shift_r(cls_start, 1, PAD)
    c2 = _shift_r(cls_start, 2, PAD)
    c3 = _shift_r(cls_start, 3, PAD)
    cls = torch.where(
        is_start, cls_start, torch.where(s1, c1, torch.where(s2, c2, c3))
    )
    if valid is not None:
        cls = torch.where(valid, cls, PAD)
    return {
        "cls": cls.to(torch.int32),
        "cls_start": cls_start,
        "is_start": is_start,
        "char_len": char_len,
        "byte": data.to(torch.int32),
    }


def classify_ascii(buf: torch.Tensor, valid: torch.Tensor) -> dict:
    """Arithmetic classifier for pure-ASCII chunks (no table gather).

    ASCII restrictions of the classes: letters a-zA-Z, digits 0-9, CR/LF,
    space, and TAB/VT/FF (the only other ASCII White_Space codepoints).
    Every byte is its own character.
    """
    b = buf.to(torch.int32)
    lower = b | 32
    is_letter = (lower >= 0x61) & (lower <= 0x7A)
    is_digit = (b >= 0x30) & (b <= 0x39)
    is_crlf = (b == 0x0A) | (b == 0x0D)
    is_space = b == 0x20
    is_ws = (b == 0x09) | (b == 0x0B) | (b == 0x0C)
    cls = torch.full_like(b, OTHER)
    cls = torch.where(is_ws, WS, cls)
    cls = torch.where(is_space, SPACE, cls)
    cls = torch.where(is_crlf, CRLF, cls)
    cls = torch.where(is_digit, NUMBER, cls)
    cls = torch.where(is_letter, LETTER, cls)
    cls = torch.where(valid, cls, PAD).to(torch.int32)
    return {
        "cls": cls,
        "cls_start": cls,
        "is_start": valid,
        "char_len": torch.ones_like(b),
        "byte": b,
    }
