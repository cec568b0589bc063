"""The reference the native chunk packer (``jtokkit_tpu_torch/pack.py``,
``csrc/pack.cc``) is held to, byte for byte: the JAX package's chunk plan,
``jtokkit_tpu.engine.device.DeviceEngine._plan_chunks``.

That plan encodes every document with ``str.encode("utf-8")`` (``None`` and
falsy items are empty), cuts a document over ``chunk_bytes - 1`` bytes at
its last safe split point within that (an ASCII letter or digit followed by
CR or LF, by one scan of the whole window), and then packs the pieces
greedily into chunks of at most ``chunk_bytes`` bytes, a zero byte between
documents, each chunk padded to its quantized size. Its chunk size is a
setting of its module, so :func:`plan_chunks` sets it, and the flat sizes
that module derives from it, for the length of one call.
"""

from typing import Optional, Sequence

from jtokkit_tpu.engine import device as jax_device

# the plan reads nothing of an engine but its static helpers
_PLANNER = jax_device.DeviceEngine.__new__(jax_device.DeviceEngine)


def plan_chunks(texts: Sequence[Optional[str]], chunk_bytes: int):
    """(buf, doc_ends, parts, ascii_only, last) of every chunk of the JAX
    package's plan at ``chunk_bytes``; ``last`` is True for the last."""
    saved = jax_device._CHUNK_BYTES, jax_device._FLAT_SIZES
    # the module's own rule for its flat sizes (jtokkit_tpu/engine/device.py)
    jax_device._CHUNK_BYTES = chunk_bytes
    jax_device._FLAT_SIZES = tuple(
        s for s in (8192, 131072, 1 << 21) if s < chunk_bytes) + (chunk_bytes,)
    try:
        chunks = list(_PLANNER._plan_chunks(texts))
    finally:
        jax_device._CHUNK_BYTES, jax_device._FLAT_SIZES = saved
    return [(*c, k == len(chunks) - 1) for k, c in enumerate(chunks)]
