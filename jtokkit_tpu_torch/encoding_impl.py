"""Concrete byte-pair encoding bound to the host oracle and (lazily) the
device engine.

Single-text calls follow the reference's semantics exactly through the host
oracle (reference ``M/GptBytePairEncoding.java``); batch calls (encode,
count, decode) run on the device engine (the two are differential-tested to
be identical). The device is fixed when the encoding is made: ``None`` means
the CUDA card, and without one the constructor raises.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

from .api.encoding import Encoding, EncodingResult
from .api.params import GptBytePairEncodingParams
from .engine.device import resolve_device
from .engine.oracle import OracleEngine
from .engine.presplit import BUILTIN_PATTERNS


class GptBytePairEncoding(Encoding):
    """A tiktoken-compatible BPE encoding."""

    def __init__(self, params: GptBytePairEncodingParams, device=None):
        self._params = params
        self._device = resolve_device(device)
        self._oracle = OracleEngine(
            params.name,
            params.pattern,
            params.encoder,
            params.special_tokens_encoder,
        )
        self._device_engine = None
        self._device_lock = threading.Lock()

    # -- engines --------------------------------------------------------

    @property
    def oracle(self) -> OracleEngine:
        return self._oracle

    def device_engine(self):
        """The device engine for this encoding (built on first use).

        Only built-in pre-split families run on the device; custom regex
        patterns return ``None`` and stay on the host path.
        """
        if self._params.pattern not in BUILTIN_PATTERNS:
            return None
        if self._device_engine is None:
            with self._device_lock:
                if self._device_engine is None:
                    from .engine.device import DeviceEngine

                    self._device_engine = DeviceEngine.from_oracle(
                        self._oracle, device=self._device
                    )
        return self._device_engine

    # -- Encoding contract ---------------------------------------------

    def encode(self, text: Optional[str]) -> List[int]:
        if text is None:
            return []
        self._oracle.check_special(text)
        return self.encode_ordinary(text)

    def encode_capped(self, text: Optional[str], max_tokens: int) -> EncodingResult:
        if text is None:
            return EncodingResult([], False)
        self._oracle.check_special(text)
        return self.encode_ordinary_capped(text, max_tokens)

    def encode_ordinary(self, text: Optional[str]) -> List[int]:
        if text is None:
            return []
        return self._oracle.encode_ordinary(text)[0]

    def encode_ordinary_capped(
        self, text: Optional[str], max_tokens: int
    ) -> EncodingResult:
        if text is None:
            return EncodingResult([], False)
        tokens, truncated = self._oracle.encode_ordinary(text, max_tokens)
        return EncodingResult(tokens, truncated)

    def decode_bytes(self, tokens: Sequence[int]) -> bytes:
        return self._oracle.decode_bytes(tokens)

    @property
    def name(self) -> str:
        return self._params.name

    @property
    def special_tokens(self) -> Dict[str, int]:
        return dict(self._oracle.special_tokens)

    # -- batch: on the device ------------------------------------------

    def encode_ordinary_batch(
        self, texts: Sequence[Optional[str]]
    ) -> List[List[int]]:
        engine = self.device_engine()
        if engine is None:
            return [self.encode_ordinary(t) for t in texts]
        return engine.encode_ordinary_batch(texts)

    def encode_batch(self, texts: Sequence[Optional[str]]) -> List[List[int]]:
        for t in texts:
            if t is not None:
                self._oracle.check_special(t)
        return self.encode_ordinary_batch(texts)

    def count_tokens_batch(self, texts: Sequence[Optional[str]]) -> List[int]:
        engine = self.device_engine()
        if engine is None:
            return [len(self.encode(t)) for t in texts]
        for t in texts:
            if t is not None:
                self._oracle.check_special(t)
        return engine.count_tokens_batch(texts)

    def decode_bytes_batch(self, token_lists) -> List[bytes]:
        engine = self.device_engine()
        if engine is None:
            return [self.decode_bytes(t) for t in token_lists]
        return engine.decode_bytes_batch(token_lists)
