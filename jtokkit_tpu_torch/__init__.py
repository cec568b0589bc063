"""jtokkit_tpu_torch — the tiktoken-class byte-pair-encoding framework in
PyTorch and CUDA.

The PyTorch port of ``jtokkit_tpu``: the same public surface (the four
OpenAI encodings r50k_base, p50k_base, p50k_edit, cl100k_base; model→encoding
registry; special-token, truncation, and error semantics), with batch encode
and count running on a CUDA card. Nothing of ``jtokkit_tpu`` or JAX is
imported; the vocabulary files are read from ``jtokkit_tpu/vocab/assets``.

Quick start::

    from jtokkit_tpu_torch import Encodings, EncodingType, ModelType

    registry = Encodings.new_default_encoding_registry()   # device="cuda"
    enc = registry.get_encoding(EncodingType.CL100K_BASE)
    enc.encode("Hello, world!")          # [9906, 11, 1917, 0]
    enc.decode([9906, 11, 1917, 0])      # "Hello, world!"
    enc.encode_ordinary_batch(docs)      # on the CUDA card
"""

from .api.encoding import Encoding, EncodingResult
from .api.errors import (
    DuplicateEncodingError,
    JTokkitTpuError,
    SpecialTokenError,
    UnknownTokenError,
    VocabularyLoadError,
)
from .api.params import GptBytePairEncodingParams
from .api.types import EncodingType, ModelType
from .encoding_impl import GptBytePairEncoding
from .registry import (
    DefaultEncodingRegistry,
    EncodingRegistry,
    Encodings,
    LazyEncodingRegistry,
)

__version__ = "0.1.0"

__all__ = [
    "Encoding",
    "EncodingResult",
    "EncodingRegistry",
    "EncodingType",
    "Encodings",
    "DefaultEncodingRegistry",
    "LazyEncodingRegistry",
    "GptBytePairEncoding",
    "GptBytePairEncodingParams",
    "ModelType",
    "JTokkitTpuError",
    "SpecialTokenError",
    "UnknownTokenError",
    "DuplicateEncodingError",
    "VocabularyLoadError",
    "__version__",
]
