"""Concrete byte-pair encoding bound to the host oracle and (lazily) the
device engine.

Single-text calls follow the reference's semantics exactly
(reference ``M/GptBytePairEncoding.java``): encode and capped encode run on
the native C++ host engine (``native.py``) for the built-in pre-split
families over a vocabulary with all 256 single bytes, else on the host
oracle; batch calls (encode, count, decode) run on the device engine (all
three are differential-tested to be identical). The device is fixed when
the encoding is made: ``None`` means the CUDA card, and without one the
constructor raises.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

from .api.encoding import Encoding, EncodingResult
from .api.params import GptBytePairEncodingParams
from .engine.device import resolve_device
from .engine.oracle import OracleEngine
from .engine.presplit import BUILTIN_PATTERNS
from .utils.spans import span


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
        self._packed = None
        self._device_engine = None
        self._native_engine = None
        self._native_tried = False
        self._device_lock = threading.RLock()

    # -- engines --------------------------------------------------------

    @property
    def oracle(self) -> OracleEngine:
        return self._oracle

    def _packed_tables(self):
        """The packed tables, loaded once for both engines."""
        with self._device_lock:
            if self._packed is None:
                from .engine.device import _maybe_asset_path
                from .vocab.tables import load_packed

                self._packed = load_packed(
                    self._params.name, self._params.encoder,
                    _maybe_asset_path(self._params.name),
                )
        return self._packed

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

                    self._device_engine = DeviceEngine(
                        self._params.name, self._params.pattern,
                        self._packed_tables(), self._oracle, device=self._device,
                    )
        return self._device_engine

    def native_engine(self):
        """The C++ host engine (built on first use; a failed build raises).

        Custom regex patterns and the vocabularies that
        ``native.engine_for`` leaves out return ``None`` and stay on the
        Python oracle.
        """
        if not self._native_tried:
            with self._device_lock:
                if not self._native_tried:
                    # a custom pattern needs no packed tables to be refused
                    if self._params.pattern in BUILTIN_PATTERNS:
                        from . import native

                        self._native_engine = native.engine_for(
                            self._packed_tables(), self._params.pattern
                        )
                    self._native_tried = True
        return self._native_engine

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
        native = self.native_engine()
        if native is not None:
            return native.encode_ordinary(text)
        return self._oracle.encode_ordinary(text)[0]

    def encode_ordinary_capped(
        self, text: Optional[str], max_tokens: int
    ) -> EncodingResult:
        if text is None:
            return EncodingResult([], False)
        native = self.native_engine()
        if native is not None:
            # the capped result is the first max_tokens tokens of the full
            # encoding with the multibyte repair applied (the reference's
            # early-exit loop and clipping give exactly this prefix,
            # M/GptBytePairEncoding.java:79-100,110-119); the native scan
            # stops at the cap, so this is O(prefix)
            prefix = native.encode_ordinary_capped_array(text, max_tokens).tolist()
            tokens, truncated = self._oracle._repair_truncation(text, prefix)
            return EncodingResult(tokens, truncated)
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
        with span(engine, "special_check"):
            for t in texts:
                if t is not None:
                    self._oracle.check_special(t)
        return engine.count_tokens_batch(texts)

    def decode_bytes_batch(self, token_lists) -> List[bytes]:
        engine = self.device_engine()
        if engine is None:
            return [self.decode_bytes(t) for t in token_lists]
        return engine.decode_bytes_batch(token_lists)
