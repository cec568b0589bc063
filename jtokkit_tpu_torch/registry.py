"""Encoding registries (reference ``M/AbstractEncodingRegistry.java:13-97``,
``M/DefaultEncodingRegistry.java``, ``M/LazyEncodingRegistry.java``).

Thread-safe by the same construction as the reference: an internal dict
guarded by a lock (the reference uses ``ConcurrentHashMap``), and immutable
encodings. A registry fixes the device of its encodings' batch engines when
it is made: ``None`` means the CUDA card, and without one it raises.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Union

from .api.encoding import Encoding
from .api.errors import DuplicateEncodingError
from .api.params import GptBytePairEncodingParams
from .api.types import EncodingType, ModelType
from .encoding_impl import GptBytePairEncoding
from .engine.device import resolve_device
from .vocab.definitions import BUILTIN_DEFINITIONS, EncodingDefinition
from .vocab.loader import load_builtin_ranks


def _build_builtin(definition: EncodingDefinition, device) -> Encoding:
    params = GptBytePairEncodingParams(
        name=definition.name,
        pattern=definition.pattern,
        encoder=load_builtin_ranks(definition.vocab_name),
        special_tokens_encoder=definition.special_tokens,
    )
    return GptBytePairEncoding(params, device=device)


# Model-name prefix fallback, most specific first
# (reference M/AbstractEncodingRegistry.java:36-50).
_PREFIX_FALLBACKS = (
    ModelType.GPT_4_32K,
    ModelType.GPT_4,
    ModelType.GPT_3_5_TURBO_16K,
    ModelType.GPT_3_5_TURBO,
)


class EncodingRegistry:
    """Registry of encodings by name, with model-name resolution."""

    def __init__(self, device=None):
        self._device = resolve_device(device)
        self._encodings: Dict[str, Encoding] = {}
        self._lock = threading.RLock()

    # -- lookup ---------------------------------------------------------

    def get_encoding(
        self, encoding: Union[EncodingType, str]
    ) -> Union[Encoding, Optional[Encoding]]:
        """By :class:`EncodingType` (raises if absent, like the reference's
        ``Objects.requireNonNull``) or by name (returns ``None`` if absent,
        like the reference's ``Optional``)."""
        if isinstance(encoding, EncodingType):
            enc = self._lookup(encoding.encoding_name, encoding)
            if enc is None:
                raise KeyError(
                    f"No encoding registered for encoding type "
                    f"{encoding.encoding_name}"
                )
            return enc
        return self._lookup(encoding, EncodingType.from_name(encoding))

    def get_encoding_for_model(
        self, model: Union[ModelType, str]
    ) -> Union[Encoding, Optional[Encoding]]:
        """By :class:`ModelType` (raises if absent) or by model name
        (``None`` if unknown), with prefix fallback for versioned names like
        ``gpt-4-0314`` (reference ``M/AbstractEncodingRegistry.java:36-50``)."""
        if isinstance(model, ModelType):
            return self.get_encoding(model.encoding_type)
        model_type = ModelType.from_name(model)
        if model_type is not None:
            return self.get_encoding(model_type.encoding_type)
        for fallback in _PREFIX_FALLBACKS:
            if model.startswith(fallback.model_name):
                return self.get_encoding(fallback.encoding_type)
        return None

    # -- registration ---------------------------------------------------

    def register_gpt_byte_pair_encoding(
        self, params: GptBytePairEncodingParams
    ) -> "EncodingRegistry":
        return self.register_custom_encoding(
            GptBytePairEncoding(params, device=self._device)
        )

    def register_custom_encoding(self, encoding: Encoding) -> "EncodingRegistry":
        with self._lock:
            if encoding.name in self._encodings:
                raise DuplicateEncodingError(
                    f"Encoding {encoding.name} already registered"
                )
            self._encodings[encoding.name] = encoding
        return self

    # -- internals ------------------------------------------------------

    def _lookup(
        self, name: str, encoding_type: Optional[EncodingType]
    ) -> Optional[Encoding]:
        """Direct dict lookup; subclasses may materialize lazily."""
        return self._encodings.get(name)

    def _add_builtin(self, encoding_type: EncodingType) -> None:
        with self._lock:
            name = encoding_type.encoding_name
            if name not in self._encodings:
                self._encodings[name] = _build_builtin(
                    BUILTIN_DEFINITIONS[name], self._device
                )


class DefaultEncodingRegistry(EncodingRegistry):
    """Eagerly loads all built-in encodings at construction
    (reference ``M/DefaultEncodingRegistry.java:16-20``)."""

    def __init__(self, device=None):
        super().__init__(device)
        for t in EncodingType:
            self._add_builtin(t)


class LazyEncodingRegistry(EncodingRegistry):
    """Loads each built-in encoding on first access
    (reference ``M/LazyEncodingRegistry.java:18-34``)."""

    def _lookup(
        self, name: str, encoding_type: Optional[EncodingType]
    ) -> Optional[Encoding]:
        enc = self._encodings.get(name)
        if enc is None and encoding_type is not None:
            self._add_builtin(encoding_type)
            enc = self._encodings.get(name)
        return enc


class Encodings:
    """Facade (reference ``M/Encodings.java:13-30``)."""

    @staticmethod
    def new_default_encoding_registry(device=None) -> DefaultEncodingRegistry:
        return DefaultEncodingRegistry(device)

    @staticmethod
    def new_lazy_encoding_registry(device=None) -> LazyEncodingRegistry:
        return LazyEncodingRegistry(device)
