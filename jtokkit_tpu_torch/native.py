"""ctypes binding for the native C++ host engine (csrc/jtokkit_native.cc).

Counterpart of ``jtokkit_tpu/native.py``. The native engine implements the
same two hot loops as the device pipeline (pre-split scanner + exact
min-rank merge) as tight scalar code over the SAME packed integer tables. It
serves the facade's single-text calls and the device engine's long-piece
chunks (``DeviceEngine(native_long=True)``).

The library is compiled with ``g++`` at first use into ``_build/``, named
by the hash of the source, the flags and the CPU that ``-march=native``
resolves to (an edited source rebuilds, and a build copied from another
machine is not loaded), and written to a temporary file that is then
renamed, so processes building at once cannot tear it. A failed build raises with the compiler's output:
nothing falls back quietly to the Python oracle or the device merge.

The library has 16 table slots per process. Tables are immutable, so every
caller gets one shared engine per (vocabulary, pattern) from
:func:`engine_for`, which also holds the rule of which vocabularies the
native engine serves.

Build ahead of use: ``python -m jtokkit_tpu_torch.native``
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_PKG_DIR, "csrc", "jtokkit_native.cc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")
MAX_SLOTS = 16  # kMaxHandles in the source
BUILD_LOG = ""  # the compiler's command and output of this process's build

_lock = threading.RLock()
_lib: Optional[ctypes.CDLL] = None
# vocabulary fingerprint -> (slot, pinned table arrays)
_slots: dict = {}
# (vocabulary fingerprint, pattern) -> the shared NativeEngine
_engines: dict = {}
_cls_table = None  # kept alive: every slot points into it


@functools.lru_cache(maxsize=None)
def _native_arch(cxx: str) -> str:
    """What ``-march=native`` means on this machine, as the compiler says;
    empty when the compiler cannot be run (the build then raises)."""
    try:
        out = subprocess.run(
            [cxx, "-march=native", "-Q", "--help=target"],
            capture_output=True, text=True, timeout=60,
        ).stdout
    except OSError:
        return ""
    return next(
        (line.split()[-1] for line in out.splitlines()
         if line.strip().startswith("-march=")), ""
    )


def library_for(source: str, stem: str, flags, key: bytes = b"") -> str:
    """Where the build of ``source`` with ``flags`` lives: ``lib<stem>_``
    and the hash of the source, the flags, the CPU that ``-march=native``
    resolves to and ``key``."""
    with open(source, "rb") as f:
        key = f.read() + " ".join((*flags, _native_arch(CXX))).encode() + key
    digest = hashlib.sha256(key).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")


def compile_library(path: str, source: str, flags, what: str) -> str:
    """Compile ``source`` into ``path`` (a temporary file, then renamed);
    returns the compiler's command and output. Raises with them on
    failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    cmd = [CXX, *flags, "-o", tmp, source]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"{CXX} failed to build {what}: {e}") from e
    log = " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"{CXX} failed to build {what}:\n{log}")
    os.replace(tmp, path)
    return log


def library_path() -> str:
    return library_for(SOURCE, "jtokkit_native", CXX_FLAGS)


def build(force: bool = False) -> str:
    """Compile the shared library unless this source has a build already;
    returns its path. Raises with the compiler's output on failure."""
    global BUILD_LOG
    path = library_path()
    if os.path.exists(path) and not force:
        return path
    BUILD_LOG = compile_library(path, SOURCE, CXX_FLAGS, "the native engine")
    return path


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(build())
                i32, i64, ptr = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p
                lib.jt_init.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, ptr, i64,
                                        ptr, ptr, i32]
                lib.jt_init.restype = ctypes.c_int
                for fn in (lib.jt_encode, lib.jt_split):
                    fn.argtypes = [i32, ptr, i64, i32, ptr]
                    fn.restype = i64
                lib.jt_encode_capped.argtypes = [i32, ptr, i64, i32, ptr, i64]
                lib.jt_encode_capped.restype = i64
                _lib = lib
    return _lib


def available() -> bool:
    """True once the library is built and loaded. A failed build raises:
    this never answers False for a broken toolchain."""
    return _load() is not None


def _fingerprint(packed) -> str:
    """Identity of a vocabulary: its byte table and token byte strings."""
    h = hashlib.sha256()
    for a in (packed.byte_to_id, packed.token_offsets, packed.token_bytes):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _slot_for(lib: ctypes.CDLL, packed) -> int:
    """The table slot holding ``packed``'s tables, initialised on first
    use and shared by every later engine over the same vocabulary."""
    global _cls_table
    key = _fingerprint(packed)
    with _lock:
        if key in _slots:
            return _slots[key][0]
        slot = len(_slots)
        if slot >= MAX_SLOTS:
            raise RuntimeError(f"too many native vocabularies (max {MAX_SLOTS})")
        if _cls_table is None:
            from .engine import charclass

            _cls_table = np.ascontiguousarray(charclass.class_table())
        refs = [
            np.ascontiguousarray(a) for a in (
                packed.byte_to_id, packed.byte_pair_id, packed.cuckoo_u,
                packed.cuckoo_v, packed.cuckoo_id, packed.token_bytes,
                packed.token_offsets,
            )
        ]
        b2i, bp, cu, cv, cid, pool, offs = refs

        def ptr(a):
            return a.ctypes.data_as(ctypes.c_void_p)

        got = lib.jt_init(
            ctypes.c_int32(slot), ptr(_cls_table), ptr(b2i), ptr(bp),
            ptr(cu), ptr(cv), ptr(cid), ctypes.c_int64(cu.shape[1]),
            ptr(pool), ptr(offs), ctypes.c_int32(packed.n_tokens),
        )
        if got != slot:
            raise RuntimeError("native engine init failed")
        _slots[key] = (slot, refs)
        return slot


def engine_for(packed, pattern: str) -> Optional["NativeEngine"]:
    """The native engine for ``packed`` under ``pattern``, built on first use
    and shared by every later caller in the process (a failed build raises).
    None for what the native engine leaves out by design: a custom pattern,
    or a vocabulary without all 256 single bytes."""
    from .engine.presplit import BUILTIN_PATTERNS

    if pattern not in BUILTIN_PATTERNS or not (packed.byte_to_id >= 0).all():
        return None
    key = (_fingerprint(packed), pattern)
    with _lock:
        if key not in _engines:
            _engines[key] = NativeEngine(packed, pattern)
        return _engines[key]


class NativeEngine:
    """Native encoder bound to one encoding's packed tables.

    The C calls are pure reads over immutable tables and release the GIL,
    so Python threads scale.
    """

    def __init__(self, packed, pattern: str):
        self._lib = _load()
        self._pattern_code = 0 if pattern == "gpt2" else 1
        self._handle = _slot_for(self._lib, packed)

    def _call(self, fn, buf: np.ndarray, out: np.ndarray, *extra) -> int:
        m = fn(
            ctypes.c_int32(self._handle),
            buf.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int64(len(buf)),
            ctypes.c_int32(self._pattern_code),
            out.ctypes.data_as(ctypes.c_void_p),
            *extra,
        )
        if m < 0:
            raise RuntimeError("native engine not initialized")
        return m

    def encode_ordinary(self, text: str) -> list:
        return self.encode_ordinary_array(text).tolist()

    def encode_ordinary_array(self, text: str) -> np.ndarray:
        return self.encode_bytes(text.encode("utf-8"))

    def encode_bytes(self, data) -> np.ndarray:
        """Encode a UTF-8 byte buffer (bytes or uint8 ndarray) directly, with
        no str round trip; the device engine's long-piece routing uses it."""
        if len(data) == 0:
            return np.zeros(0, dtype=np.int32)
        buf = np.ascontiguousarray(
            np.frombuffer(data, dtype=np.uint8)
            if isinstance(data, (bytes, bytearray, memoryview)) else data
        )
        out = np.empty(len(buf), dtype=np.int32)
        return out[: self._call(self._lib.jt_encode, buf, out)]

    def encode_ordinary_capped_array(self, text: str, max_tokens: int) -> np.ndarray:
        """First ``max_tokens`` tokens of the full encoding. O(prefix): the
        native scan stops once the cap is reached (the reference's maxTokens
        early exit, ``M/GptBytePairEncoding.java:79,281-283``)."""
        data = text.encode("utf-8")
        if max_tokens <= 0 or not data:
            return np.zeros(0, dtype=np.int32)
        out = np.empty(max_tokens, dtype=np.int32)
        m = self._call(
            self._lib.jt_encode_capped, np.frombuffer(data, dtype=np.uint8), out,
            ctypes.c_int64(max_tokens),
        )
        return out[:m]

    def split_ends(self, text: str) -> np.ndarray:
        """Piece end byte-offsets (for differential testing)."""
        data = text.encode("utf-8")
        if not data:
            return np.zeros(0, dtype=np.int32)
        out = np.empty(len(data), dtype=np.int32)
        m = self._call(self._lib.jt_split, np.frombuffer(data, dtype=np.uint8), out)
        return out[:m].copy()


if __name__ == "__main__":
    print("native build:", build(force=True))
