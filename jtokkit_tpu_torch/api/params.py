"""Custom-encoding parameter object (reference
``M/api/GptBytePairEncodingParams.java:22-63``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict


@dataclass(frozen=True)
class GptBytePairEncodingParams:
    """Configuration for a byte-pair encoding.

    ``pattern`` is either one of the built-in pre-split families (``"gpt2"``,
    ``"cl100k"`` — these run fully vectorized on device) or an arbitrary
    regex pattern string (host pre-split via the ``regex`` module; the merge
    still runs on device).
    """

    name: str
    pattern: str
    encoder: Dict[bytes, int] = field(default_factory=dict)
    special_tokens_encoder: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        if not self.name:
            raise ValueError("name must be non-empty")
