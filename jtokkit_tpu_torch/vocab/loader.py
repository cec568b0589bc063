"""Vocabulary loading: `.tiktoken` rank files → host maps.

File format (reference ``M/EncodingFactory.java:148-158``): one
``base64(token_bytes) <space> rank`` pair per line, split on whitespace;
malformed lines or a missing file raise :class:`VocabularyLoadError`
(the reference throws ``IllegalStateException``).
"""

from __future__ import annotations

import base64
import binascii
import os
from typing import Dict

from ..api.errors import VocabularyLoadError

# The vocabulary files are data shared with the JAX package: read them by
# path from its asset directory (nothing is imported from it).
_ASSET_DIR = os.path.join(
    os.path.dirname(__file__), "..", "..", "jtokkit_tpu", "vocab", "assets"
)

_ASSET_FILES = {
    "r50k_base": "r50k_base.tiktoken",
    "p50k_base": "p50k_base.tiktoken",
    # p50k_edit shares the p50k_base ranks (reference M/EncodingFactory.java:92)
    "p50k_edit": "p50k_base.tiktoken",
    "cl100k_base": "cl100k_base.tiktoken",
}


def asset_path(vocab_name: str) -> str:
    try:
        return os.path.join(_ASSET_DIR, _ASSET_FILES[vocab_name])
    except KeyError:
        raise VocabularyLoadError(f"No built-in vocabulary named {vocab_name!r}")


def load_ranks(path: str) -> Dict[bytes, int]:
    """Parse a `.tiktoken` rank file into a bytes → rank map."""
    if not os.path.exists(path):
        raise VocabularyLoadError(f"Could not find vocabulary file {path}")
    ranks: Dict[bytes, int] = {}
    try:
        with open(path, "rb") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                parts = line.split(None, 1)
                if len(parts) != 2:
                    raise VocabularyLoadError(
                        f"Invalid line in {path}: {line!r}"
                    )
                try:
                    token = base64.b64decode(parts[0], validate=True)
                    rank = int(parts[1])
                except (binascii.Error, ValueError) as e:
                    raise VocabularyLoadError(
                        f"Invalid line in {path}: {line!r}"
                    ) from e
                ranks[token] = rank
    except OSError as e:
        raise VocabularyLoadError(f"Could not load {path}") from e
    return ranks


def load_builtin_ranks(vocab_name: str) -> Dict[bytes, int]:
    return load_ranks(asset_path(vocab_name))
