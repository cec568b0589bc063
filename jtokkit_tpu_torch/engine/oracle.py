"""Host reference engine: bit-exact oracle for encode/decode.

Pure-Python implementation of the tiktoken byte-pair-merge algorithm with the
exact semantics of the reference engine (``M/GptBytePairEncoding.java``):

- regex pre-split (hand-rolled scanners, :mod:`.presplit`)
- whole-piece direct hit (``:81-83``)
- min-rank merge loop with leftmost tie-break and neighbor-rank recompute
  before removal (``:200-275``)
- maxTokens truncation with multibyte repair (``:90-100,110-119``)
- special-token guard on ``encode``/``count_tokens`` (``:52-56``)
- decode with vocab → special → error fallback (``:302-314``)

Everything device-side is differential-tested against this module.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from ..api.errors import SpecialTokenError, UnknownTokenError
from . import presplit

_MAX_RANK = 1 << 62


def byte_pair_merge(piece: bytes, ranks: Dict[bytes, int]) -> List[int]:
    """Merge one piece into token ids (reference ``M/GptBytePairEncoding.java:200-275``).

    ``parts`` is a list of ``[byte_index, rank]`` over ``len(piece)+1``
    boundaries; ``rank`` of boundary i is the rank of the byte span covering
    the pair starting at i, or MAX if that span is not in the vocabulary.
    """
    n = len(piece)
    parts: List[List[int]] = [[i, _MAX_RANK] for i in range(n + 1)]

    def get_rank(start: int, skip: int) -> int:
        if start + skip + 2 >= len(parts):
            return _MAX_RANK
        span = piece[parts[start][0] : parts[start + skip + 2][0]]
        return ranks.get(span, _MAX_RANK)

    for i in range(len(parts) - 2):
        parts[i][1] = get_rank(i, 0)

    while len(parts) > 1:
        min_rank = _MAX_RANK
        min_idx = 0
        for i in range(len(parts) - 1):
            if parts[i][1] < min_rank:
                min_rank = parts[i][1]
                min_idx = i
        if min_rank == _MAX_RANK:
            break
        # recompute neighbor ranks (skip=1) BEFORE removing the merged boundary
        parts[min_idx][1] = get_rank(min_idx, 1)
        if min_idx > 0:
            parts[min_idx - 1][1] = get_rank(min_idx - 1, 1)
        del parts[min_idx + 1]

    return [
        ranks[piece[parts[i][0] : parts[i + 1][0]]] for i in range(len(parts) - 1)
    ]


class OracleEngine:
    """Single-encoding host engine over a rank map."""

    def __init__(
        self,
        name: str,
        pattern: str,  # "gpt2" | "cl100k"
        ranks: Dict[bytes, int],
        special_tokens: Dict[str, int],
    ):
        self.name = name
        self.pattern = pattern
        self.ranks = ranks
        self.special_tokens = dict(special_tokens)
        self._id_to_bytes: Dict[int, bytes] = {r: b for b, r in ranks.items()}
        self._id_to_special: Dict[int, str] = {
            r: s for s, r in special_tokens.items()
        }

    # -- encode ---------------------------------------------------------

    def check_special(self, text: str) -> None:
        """Reference ``M/GptBytePairEncoding.java:52-56``."""
        for special in self.special_tokens:
            if special in text:
                raise SpecialTokenError(
                    "Encoding special tokens is not supported yet."
                )

    def encode_ordinary(
        self, text: Optional[str], max_tokens: Optional[int] = None
    ) -> Tuple[List[int], bool]:
        """Returns (tokens, truncated). Null text → empty result
        (reference ``:72-74``)."""
        if text is None:
            return [], False
        out: List[int] = []
        # the splitter is a generator: with max_tokens set, the scan stops
        # after O(max_tokens) pieces, like the reference's early-exited
        # Matcher.find() loop (M/GptBytePairEncoding.java:79,281-283)
        for a, b in presplit.compile_splitter(self.pattern)(text):
            if max_tokens is not None and len(out) >= max_tokens:
                break
            piece = text[a:b].encode("utf-8")
            rank = self.ranks.get(piece)
            if rank is not None:
                out.append(rank)
            else:
                merged = byte_pair_merge(piece, self.ranks)
                if max_tokens is not None:
                    merged = merged[: max_tokens - len(out)]
                out.extend(merged)
        if max_tokens is not None:
            return self._repair_truncation(text, out)
        return out, False

    def _repair_truncation(
        self, text: str, out: List[int]
    ) -> Tuple[List[int], bool]:
        """Pop trailing tokens until the decoded prefix is a string prefix of
        the input (multibyte repair, reference ``:90-100``)."""
        for tokens_to_remove in range(len(out) + 1):
            tokens = out[: len(out) - tokens_to_remove]
            decoded = self.decode(tokens)
            if text.startswith(decoded):
                return tokens, len(text) > len(decoded)
        return [], len(text) > 0

    def encode(
        self, text: Optional[str], max_tokens: Optional[int] = None
    ) -> Tuple[List[int], bool]:
        if text is None:
            return [], False
        self.check_special(text)
        return self.encode_ordinary(text, max_tokens)

    def count_tokens(self, text: Optional[str]) -> int:
        return len(self.encode(text)[0])

    def count_tokens_ordinary(self, text: Optional[str]) -> int:
        return len(self.encode_ordinary(text)[0])

    # -- decode ---------------------------------------------------------

    def decode_token_bytes(self, token: int) -> bytes:
        b = self._id_to_bytes.get(token)
        if b is not None:
            return b
        s = self._id_to_special.get(token)
        if s is not None:
            return s.encode("utf-8")
        raise UnknownTokenError(f"Unknown token for decoding: {token}")

    def decode_bytes(self, tokens: Iterable[int]) -> bytes:
        return b"".join(self.decode_token_bytes(t) for t in tokens)

    def decode(self, tokens: Iterable[int]) -> str:
        # Java's `new String(bytes, UTF_8)` replaces malformed sequences
        return self.decode_bytes(tokens).decode("utf-8", errors="replace")
