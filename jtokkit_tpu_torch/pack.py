"""ctypes binding for the chunk packer (csrc/pack.cc).

The device engine's batch calls pack their documents into chunks here, one
chunk a step: :class:`ChunkPacker` hands each chunk's UTF-8 bytes (written
by the packer straight into a staging block, pinned when the chunk goes to
a CUDA card), its document ends and its documents' batch indices. The
un-planned call (``DeviceEngine._stream_stage_a``) issues a chunk's Stage A
before it packs the next, and the packer reads no document past the first
that did not fit; ``DeviceEngine._plan_chunks`` runs the same steps.

The library is built like the native engine (``native.py``: ``g++`` at
first use into ``_build/``, named by the hash of the source, the flags, the
CPU and here the interpreter's version too, written to a temporary file
and renamed; a failed build raises). It reads ``str`` objects through
Python's C API, so it is loaded with ``ctypes.PyDLL``: it runs with the GIL
held and raises the Python error it sets.

Build ahead of use: ``python -m jtokkit_tpu_torch.pack``
"""

from __future__ import annotations

import ctypes
import os
import sys
import sysconfig
import threading
from collections.abc import Sequence
from typing import Optional

import numpy as np
import torch

from . import native

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "pack.cc")
CXX_FLAGS = (*native.CXX_FLAGS, "-I" + sysconfig.get_paths()["include"])
BUILD_LOG = ""  # the compiler's command and output of this process's build

_lock = threading.Lock()
_lib: Optional[ctypes.PyDLL] = None
_NEED_BLOCK = -2  # jt_pack_chunk: the chunk's one document needs a larger block


def library_path() -> str:
    return native.library_for(SOURCE, "jtokkit_pack", CXX_FLAGS,
                              sys.version.encode())


def build(force: bool = False) -> str:
    """Compile the packer unless this source has a build already; returns
    its path. Raises with the compiler's output on failure."""
    global BUILD_LOG
    path = library_path()
    if os.path.exists(path) and not force:
        return path
    BUILD_LOG = native.compile_library(path, SOURCE, CXX_FLAGS, "the chunk packer")
    return path


def declare(lib: ctypes.PyDLL) -> None:
    """Set the argument and result types of a build's functions."""
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    lib.jt_pack_chunk.argtypes = [ctypes.py_object, ptr, ptr, i64, ptr, ptr, i64,
                                  ptr, i64, ptr, i64, ptr]
    lib.jt_pack_chunk.restype = i64


def _load() -> ctypes.PyDLL:
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = ctypes.PyDLL(build())
                declare(lib)
                _lib = lib
    return _lib


class ChunkPacker:
    """The documents of ``texts`` packed into chunks of at most
    ``chunk_bytes`` (an iterator of chunks).

    Each step is one call of the packer: it reads documents from the cursor
    on, writes each one's UTF-8 and a zero byte between documents into a
    new block and stops before the first document that does not fit, which
    starts the next step (a document over ``chunk_bytes - 1`` bytes is cut
    at its last safe point within that, a letter or digit followed by CR or
    LF; one with no such point is a chunk of its own). A chunk is (buf,
    doc_ends, parts, ascii_only, last): ``buf`` uint8 and ``doc_ends``
    int32 CPU tensors, pinned where ``pin``, padded with zeros to the first
    of ``sizes`` that holds the bytes and with the last end to the first of
    ``doc_sizes`` that holds the ends (else to a power of two);
    ``parts[k]`` the batch index of chunk-document k; ``last`` whether the
    batch ends with it. ``None`` and a falsy item are empty documents; any
    other item that is not a ``str``, and a ``str`` that cannot be encoded,
    gives what its ``encode("utf-8")`` gives, errors included.

    ``wide_docs`` counts the documents read from non-ASCII ``str``
    storage (transcoded rather than copied).
    """

    def __init__(self, texts, chunk_bytes: int, sizes, doc_sizes,
                 pin: bool = False):
        self._lib = _load()
        self._texts = (texts if isinstance(texts, (list, tuple, Sequence))
                       else list(texts))
        self._chunk_bytes = int(chunk_bytes)
        self._sizes = np.asarray(sizes, dtype=np.int64)
        self._doc_sizes = np.asarray(doc_sizes, dtype=np.int64)
        self._pin = pin
        # cursor: document, character offset in it, its UTF-8 bytes from there
        self._cursor = np.zeros(3, dtype=np.int64)
        self._result = np.zeros(8, dtype=np.int64)
        # a chunk holds at most chunk_bytes documents (each one byte or more
        # with its separator), and a lone first one
        self._ends = np.empty(self._chunk_bytes + 1, dtype=np.int32)
        self._parts = np.empty(self._chunk_bytes + 1, dtype=np.int32)
        self._done = False
        self.wide_docs = 0

    def _block(self, n: int, dtype) -> torch.Tensor:
        return torch.empty(n, dtype=dtype, pin_memory=self._pin)

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        block = self._block(self._chunk_bytes, torch.uint8)
        res = self._result
        while True:
            n = self._lib.jt_pack_chunk(
                self._texts, self._cursor.ctypes.data, block.data_ptr(),
                block.numel(), self._ends.ctypes.data, self._parts.ctypes.data,
                self._chunk_bytes, self._sizes.ctypes.data, len(self._sizes),
                self._doc_sizes.ctypes.data, len(self._doc_sizes), res.ctypes.data,
            )
            if n != _NEED_BLOCK:
                break
            block = self._block(int(res[4]), torch.uint8)
        if n == 0:
            self._done = True
            raise StopIteration
        total, size, ascii_only, wide, d_size, last = (
            int(res[0]), int(res[1]), bool(res[2]), int(res[3]), int(res[5]),
            bool(res[6]))
        self.wide_docs += wide
        self._done = last
        doc_ends = self._block(d_size, torch.int32)
        ends = doc_ends.numpy()
        ends[:n] = self._ends[:n]
        ends[n:] = total
        return block[:size], doc_ends, self._parts[:n].tolist(), ascii_only, last


if __name__ == "__main__":
    print("chunk packer build:", build(force=True))
