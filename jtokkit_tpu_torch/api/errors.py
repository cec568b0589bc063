"""Exception types, mirroring the reference's error semantics.

Mapping to the reference:

- :class:`SpecialTokenError` ← ``UnsupportedOperationException`` thrown by
  ``encode``/``countTokens`` when the text contains a special-token literal
  (reference ``M/GptBytePairEncoding.java:52-56``).
- :class:`UnknownTokenError` ← ``IllegalArgumentException("Unknown token for
  decoding: ...")`` (reference ``M/GptBytePairEncoding.java:313``).
- :class:`DuplicateEncodingError` ← ``IllegalStateException("Encoding ...
  already registered")`` (reference ``M/AbstractEncodingRegistry.java:73``).
- :class:`VocabularyLoadError` ← ``IllegalStateException`` on resource load
  (reference ``M/EncodingFactory.java:142,151,162``).
"""


class JTokkitTpuError(Exception):
    """Base class for all framework errors."""


class SpecialTokenError(JTokkitTpuError, ValueError):
    """Raised when ``encode``/``count_tokens`` sees a special-token literal."""


class UnknownTokenError(JTokkitTpuError, ValueError):
    """Raised when decoding a token id not present in the vocabulary."""


class DuplicateEncodingError(JTokkitTpuError, RuntimeError):
    """Raised when registering an encoding name that already exists."""


class VocabularyLoadError(JTokkitTpuError, RuntimeError):
    """Raised when a vocabulary asset is missing or malformed."""
