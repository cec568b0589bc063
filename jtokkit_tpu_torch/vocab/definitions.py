"""Built-in encoding definitions (reference ``M/EncodingFactory.java:24-109``).

Each definition bundles: the vocabulary asset, the pre-split pattern family
("gpt2" or "cl100k", see :mod:`jtokkit_tpu_torch.engine.presplit`), and the
special-token table.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

ENDOFTEXT = "<|endoftext|>"
FIM_PREFIX = "<|fim_prefix|>"
FIM_MIDDLE = "<|fim_middle|>"
FIM_SUFFIX = "<|fim_suffix|>"
ENDOFPROMPT = "<|endofprompt|>"

SPECIAL_TOKENS_X50K_BASE: Dict[str, int] = {ENDOFTEXT: 50256}

SPECIAL_TOKENS_P50K_EDIT: Dict[str, int] = {
    ENDOFTEXT: 50256,
    FIM_PREFIX: 50281,
    FIM_MIDDLE: 50282,
    FIM_SUFFIX: 50283,
}

SPECIAL_TOKENS_CL100K_BASE: Dict[str, int] = {
    ENDOFTEXT: 100257,
    FIM_PREFIX: 100258,
    FIM_MIDDLE: 100259,
    FIM_SUFFIX: 100260,
    ENDOFPROMPT: 100276,
}


@dataclass(frozen=True)
class EncodingDefinition:
    name: str
    pattern: str  # "gpt2" | "cl100k"
    vocab_name: str  # key into vocab assets
    special_tokens: Dict[str, int] = field(default_factory=dict)


BUILTIN_DEFINITIONS: Dict[str, EncodingDefinition] = {
    d.name: d
    for d in (
        EncodingDefinition(
            "r50k_base", "gpt2", "r50k_base", SPECIAL_TOKENS_X50K_BASE
        ),
        EncodingDefinition(
            "p50k_base", "gpt2", "p50k_base", SPECIAL_TOKENS_X50K_BASE
        ),
        EncodingDefinition(
            "p50k_edit", "gpt2", "p50k_edit", SPECIAL_TOKENS_P50K_EDIT
        ),
        EncodingDefinition(
            "cl100k_base", "cl100k", "cl100k_base", SPECIAL_TOKENS_CL100K_BASE
        ),
    )
}
