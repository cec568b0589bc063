"""Encoding and model enumerations (reference ``M/api/EncodingType.java:9-31``
and ``M/api/ModelType.java:9-111``)."""

from __future__ import annotations

import enum
from typing import Optional


class EncodingType(enum.Enum):
    R50K_BASE = "r50k_base"
    P50K_BASE = "p50k_base"
    P50K_EDIT = "p50k_edit"
    CL100K_BASE = "cl100k_base"

    @property
    def encoding_name(self) -> str:
        return self.value

    @classmethod
    def from_name(cls, name: str) -> Optional["EncodingType"]:
        for t in cls:
            if t.value == name:
                return t
        return None


class ModelType(enum.Enum):
    """OpenAI model name → (encoding, max context length) triples
    (reference ``M/api/ModelType.java:11-53``)."""

    # chat
    GPT_4 = ("gpt-4", EncodingType.CL100K_BASE, 8192)
    GPT_4_32K = ("gpt-4-32k", EncodingType.CL100K_BASE, 32768)
    GPT_3_5_TURBO = ("gpt-3.5-turbo", EncodingType.CL100K_BASE, 4097)
    GPT_3_5_TURBO_16K = ("gpt-3.5-turbo-16k", EncodingType.CL100K_BASE, 16384)
    # text
    TEXT_DAVINCI_003 = ("text-davinci-003", EncodingType.P50K_BASE, 4097)
    TEXT_DAVINCI_002 = ("text-davinci-002", EncodingType.P50K_BASE, 4097)
    TEXT_DAVINCI_001 = ("text-davinci-001", EncodingType.R50K_BASE, 2049)
    TEXT_CURIE_001 = ("text-curie-001", EncodingType.R50K_BASE, 2049)
    TEXT_BABBAGE_001 = ("text-babbage-001", EncodingType.R50K_BASE, 2049)
    TEXT_ADA_001 = ("text-ada-001", EncodingType.R50K_BASE, 2049)
    DAVINCI = ("davinci", EncodingType.R50K_BASE, 2049)
    CURIE = ("curie", EncodingType.R50K_BASE, 2049)
    BABBAGE = ("babbage", EncodingType.R50K_BASE, 2049)
    ADA = ("ada", EncodingType.R50K_BASE, 2049)
    # code
    CODE_DAVINCI_002 = ("code-davinci-002", EncodingType.P50K_BASE, 8001)
    CODE_DAVINCI_001 = ("code-davinci-001", EncodingType.P50K_BASE, 8001)
    CODE_CUSHMAN_002 = ("code-cushman-002", EncodingType.P50K_BASE, 2048)
    CODE_CUSHMAN_001 = ("code-cushman-001", EncodingType.P50K_BASE, 2048)
    DAVINCI_CODEX = ("davinci-codex", EncodingType.P50K_BASE, 4096)
    CUSHMAN_CODEX = ("cushman-codex", EncodingType.P50K_BASE, 2048)
    # edit
    TEXT_DAVINCI_EDIT_001 = ("text-davinci-edit-001", EncodingType.P50K_EDIT, 3000)
    CODE_DAVINCI_EDIT_001 = ("code-davinci-edit-001", EncodingType.P50K_EDIT, 3000)
    # embeddings
    TEXT_EMBEDDING_ADA_002 = ("text-embedding-ada-002", EncodingType.CL100K_BASE, 8191)
    # old embeddings
    TEXT_SIMILARITY_DAVINCI_001 = ("text-similarity-davinci-001", EncodingType.R50K_BASE, 2046)
    TEXT_SIMILARITY_CURIE_001 = ("text-similarity-curie-001", EncodingType.R50K_BASE, 2046)
    TEXT_SIMILARITY_BABBAGE_001 = ("text-similarity-babbage-001", EncodingType.R50K_BASE, 2046)
    TEXT_SIMILARITY_ADA_001 = ("text-similarity-ada-001", EncodingType.R50K_BASE, 2046)
    TEXT_SEARCH_DAVINCI_DOC_001 = ("text-search-davinci-doc-001", EncodingType.R50K_BASE, 2046)
    TEXT_SEARCH_CURIE_DOC_001 = ("text-search-curie-doc-001", EncodingType.R50K_BASE, 2046)
    TEXT_SEARCH_BABBAGE_DOC_001 = ("text-search-babbage-doc-001", EncodingType.R50K_BASE, 2046)
    TEXT_SEARCH_ADA_DOC_001 = ("text-search-ada-doc-001", EncodingType.R50K_BASE, 2046)
    CODE_SEARCH_BABBAGE_CODE_001 = ("code-search-babbage-code-001", EncodingType.R50K_BASE, 2046)
    CODE_SEARCH_ADA_CODE_001 = ("code-search-ada-code-001", EncodingType.R50K_BASE, 2046)

    def __init__(self, model_name: str, encoding_type: EncodingType, max_context_length: int):
        self.model_name = model_name
        self.encoding_type = encoding_type
        self.max_context_length = max_context_length

    def get_name(self) -> str:
        return self.model_name

    def get_encoding_type(self) -> EncodingType:
        return self.encoding_type

    def get_max_context_length(self) -> int:
        return self.max_context_length

    @classmethod
    def from_name(cls, name: str) -> Optional["ModelType"]:
        return _NAME_TO_MODEL.get(name)


_NAME_TO_MODEL = {m.model_name: m for m in ModelType}
