"""Counting tokens for ChatML chat requests.

Port of the reference's recipe (reference
``docs/docs/getting-started/recipes/chatml.md:9-41``, itself based on the
OpenAI cookbook): chat models wrap each message in ChatML framing tokens that
must be counted on top of the content. A copy of
``jtokkit_tpu/recipes/chatml.py`` over the port's registry.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from ..registry import EncodingRegistry


@dataclass(frozen=True)
class ChatMessage:
    role: str
    content: str
    name: Optional[str] = None


def count_message_tokens(
    registry: EncodingRegistry,
    model: str,
    messages: Sequence[ChatMessage],
) -> int:
    """Total prompt tokens for a ChatML request against ``model``.

    Raises ``ValueError`` for models without known ChatML framing.
    """
    encoding = registry.get_encoding_for_model(model)
    if encoding is None:
        raise ValueError(f"Unsupported model: {model}")
    if model.startswith("gpt-4"):
        tokens_per_message = 3
        tokens_per_name = 1
    elif model.startswith("gpt-3.5-turbo"):
        # every message follows <|start|>{role/name}\n{content}<|end|>\n
        tokens_per_message = 4
        tokens_per_name = -1  # if there's a name, the role is omitted
    else:
        raise ValueError(f"Unsupported model: {model}")

    total = 0
    for message in messages:
        total += tokens_per_message
        total += encoding.count_tokens(message.content)
        total += encoding.count_tokens(message.role)
        if message.name is not None:
            total += encoding.count_tokens(message.name)
            total += tokens_per_name
    total += 3  # every reply is primed with <|start|>assistant<|message|>
    return total
