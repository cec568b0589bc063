"""Public tokenizer contract (reference ``M/api/Encoding.java:29-189`` and
``M/api/EncodingResult.java:8-38``)."""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import List, Optional, Sequence


@dataclass(frozen=True)
class EncodingResult:
    """Tokens plus whether the input was truncated to fit ``max_tokens``."""

    tokens: List[int] = field(default_factory=list)
    truncated: bool = False

    def __iter__(self):
        return iter(self.tokens)

    def __len__(self):
        return len(self.tokens)


class Encoding(ABC):
    """A byte-pair encoding over UTF-8 text.

    Mirrors the reference interface: ``encode``/``encode_ordinary`` (with and
    without a token cap), ``count_tokens``/``count_tokens_ordinary``,
    ``decode``/``decode_bytes``, and ``name``. Batch variants are the
    batch extension served by the device engine.
    """

    # -- single text ----------------------------------------------------

    @abstractmethod
    def encode(self, text: Optional[str]) -> List[int]:
        """Token ids for ``text``. Raises
        :class:`~jtokkit_tpu_torch.api.errors.SpecialTokenError` if the text
        contains a special-token literal. ``None`` → ``[]``."""

    @abstractmethod
    def encode_capped(self, text: Optional[str], max_tokens: int) -> EncodingResult:
        """Like :meth:`encode`, truncated to at most ``max_tokens`` tokens
        without splitting multibyte characters."""

    @abstractmethod
    def encode_ordinary(self, text: Optional[str]) -> List[int]:
        """Token ids for ``text``; special-token literals are plain text."""

    @abstractmethod
    def encode_ordinary_capped(
        self, text: Optional[str], max_tokens: int
    ) -> EncodingResult:
        """Like :meth:`encode_ordinary` with a token cap."""

    def count_tokens(self, text: Optional[str]) -> int:
        return len(self.encode(text))

    def count_tokens_ordinary(self, text: Optional[str]) -> int:
        return len(self.encode_ordinary(text))

    # -- decode ---------------------------------------------------------

    @abstractmethod
    def decode_bytes(self, tokens: Sequence[int]) -> bytes:
        """Raw UTF-8 bytes for ``tokens``. Raises
        :class:`~jtokkit_tpu_torch.api.errors.UnknownTokenError` for ids outside
        the vocabulary and special-token tables."""

    def decode(self, tokens: Sequence[int]) -> str:
        return self.decode_bytes(tokens).decode("utf-8", errors="replace")

    # -- identity -------------------------------------------------------

    @property
    @abstractmethod
    def name(self) -> str:
        """The encoding's name, e.g. ``"cl100k_base"``."""

    def get_name(self) -> str:  # reference-style accessor
        return self.name

    # -- batch (device extension) --------------------------------------

    def encode_batch(self, texts: Sequence[Optional[str]]) -> List[List[int]]:
        return [self.encode(t) for t in texts]

    def encode_ordinary_batch(
        self, texts: Sequence[Optional[str]]
    ) -> List[List[int]]:
        return [self.encode_ordinary(t) for t in texts]

    def count_tokens_batch(self, texts: Sequence[Optional[str]]) -> List[int]:
        return [len(t) for t in self.encode_batch(texts)]

    def decode_bytes_batch(
        self, token_lists: Sequence[Sequence[int]]
    ) -> List[bytes]:
        return [self.decode_bytes(t) for t in token_lists]

    def decode_batch(self, token_lists: Sequence[Sequence[int]]) -> List[str]:
        return [
            b.decode("utf-8", errors="replace")
            for b in self.decode_bytes_batch(token_lists)
        ]
