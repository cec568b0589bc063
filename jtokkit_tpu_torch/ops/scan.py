"""Multi-leaf inclusive prefix scans: the hand-written CUDA kernel and its
plain PyTorch version.

Replaces ``jtokkit_tpu/ops/pallas_scan.py::_scan_stacked`` (reached through
its ``scan_leaves``). Stage A scans several int32 leaves of one length in one
call, each with its own combine:

- ``max``  -- running maximum (leaves hold -1 for unset, else values >= 0)
- ``last`` -- the latest value >= 0 in scan order wins (identity -1)
- ``add``  -- running sum, wrapping like int32 addition (identity 0)

``reverse=True`` scans from the highest index down (suffix scans).

A CUDA tensor goes to the kernel in ``csrc/scan.cu`` and nowhere else; a CPU
tensor goes to :func:`scan_leaves_plain`. The kernel is memory-bound: it must
read and write ``L*n*4`` bytes each (25.2 MB at L = 3, n = 2^20, about
7.5 us at the H100's 3.35 TB/s). It is a single-pass scan with decoupled
look-back: one launch per call, each input word read once; see the note at
the top of the source.

The kernel's tiles talk through a small scratch (a ticket counter and one
64-bit status word per tile and leaf). The scratch is persistent: this
module keeps one per (device, stream), zeroed when it is made and grown when
a call needs more, so a call is one launch and allocates only its output.
The kernel tells a call's status words from an earlier call's by an epoch it
keeps in the scratch itself; status words hold 30 bits of it, so the wrapper
zeroes them once in :data:`CLEAR_EVERY` calls. Leaves and outputs move as
16-byte words; a leaf that is a view at an odd offset (not 16-byte aligned)
is taken all the same, through the kernel's 4-byte loads.

Under a CUDA graph capture a call is recorded, not launched: it must find
its stream's scratch already made and large enough (a tensor made during a
capture would belong to the graph's pool and be zeroed again by every
replay), so the capturing code first runs the same scans once on the capture
stream, and the wrapper raises otherwise. A recorded call adds to
:data:`CAPTURED_CALLS` and not to :data:`KERNEL_LAUNCHES`, which counts only
where this wrapper launches the kernel itself. Whoever replays the graph
calls :func:`count_replay` first: it keeps the clear of the status words on
schedule and adds the scans the graph holds to :data:`REPLAYED_SCANS`, a
number derived from the recording and not counted at a launch.

The library is built and loaded by :mod:`._build` at the first launch.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import KernelLibrary, cuda_device_index

MAX_LEAVES = 4
KINDS = {"max": 0, "last": 1, "add": 2}

TILE = 8192  # scan positions per block of the kernel
HEADER_WORDS = 2  # 64-bit words of the scratch ahead of the status words
MIN_SCRATCH_WORDS = 1 << 13  # 64 KB: L = 3 at n = 2^24 without growing
EPOCH_BITS = 30  # of the call epoch in a status word
CLEAR_EVERY = (1 << EPOCH_BITS) - 1  # calls between two clears of a scratch

# plain counters: wrapper launches of the kernel, and scans that took the
# plain version because their tensors lay on the CPU
KERNEL_LAUNCHES = 0
PLAIN_CALLS = 0
# calls recorded into a CUDA graph under capture (no launch of their own)
CAPTURED_CALLS = 0
# scans that graph replays were told to hold (count_replay); the wrapper does
# not see these launches, so a device profile is what confirms them
REPLAYED_SCANS = 0


def declare_functions(lib: ctypes.CDLL) -> None:
    vp = ctypes.c_void_p
    lib.jt_scan_leaves.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, vp,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, vp, ctypes.c_longlong, ctypes.c_int, vp,
    ]
    lib.jt_scan_leaves.restype = ctypes.c_int
    for fn in (lib.jt_scan_tile, lib.jt_scan_header_words):
        fn.argtypes = []
        fn.restype = ctypes.c_int


def _declare(lib: ctypes.CDLL) -> None:
    declare_functions(lib)
    if (lib.jt_scan_tile(), lib.jt_scan_header_words()) != (TILE, HEADER_WORDS):
        raise RuntimeError("the scan library's tile or header differs from ops/scan.py")


LIBRARY = KernelLibrary("scan", _declare)


class _Scratch:
    """One stream's scratch: int64 words (zeroed when made) and the calls
    since its status words were last all zero."""

    __slots__ = ("words", "calls")

    def __init__(self, words: torch.Tensor):
        self.words = words
        self.calls = 0


SCRATCH: dict = {}  # (device index, stream handle) -> _Scratch


def scratch_words(n_leaves: int, n: int) -> int:
    """64-bit words a scan of ``n_leaves`` leaves of length ``n`` needs."""
    return HEADER_WORDS + n_leaves * (-(-n // TILE))


def scratch_for(device: torch.device, index, stream: int, n_words: int):
    """The persistent scratch of (device ``index``, ``stream``), at least
    ``n_words`` long, counted as used by one more call.

    A new or grown scratch is a zeroed tensor made on the current stream
    (the caller's, which is ``stream``), so the one it replaces returns to
    the allocator in stream order. Two streams never share one. Under a
    graph capture nothing may be made or cleared: the scratch must be there.
    """
    key = (index, stream)
    entry = SCRATCH.get(key)
    renew = entry is None or entry.words.numel() < n_words
    if (renew or entry.calls >= CLEAR_EVERY) and (
        device.type == "cuda" and torch.cuda.is_current_stream_capturing()
    ):
        raise RuntimeError(
            "scan under a CUDA graph capture: the capture stream has no"
            " scratch ready for this call; run the same scans once on that"
            " stream before capturing"
        )
    if renew:
        size = max(MIN_SCRATCH_WORDS, 1 << (n_words - 1).bit_length())
        entry = SCRATCH[key] = _Scratch(
            torch.zeros(size, dtype=torch.int64, device=device)
        )
    elif entry.calls >= CLEAR_EVERY:
        # the epoch in a status word is about to come round again
        entry.words[HEADER_WORDS:].zero_()
        entry.calls = 0
    entry.calls += 1
    return entry.words


def count_replay(device: torch.device, stream: int, n_scans: int) -> None:
    """Account for one replay of a CUDA graph that holds ``n_scans`` scan
    calls recorded on ``stream`` (a stream handle); call it just before
    ``graph.replay()``, on the stream that replays.

    Adds the scans to the scratch's calls since its last clear (a replay
    advances the epoch as launches do) and to :data:`REPLAYED_SCANS`, and
    clears the status words first when the replay would carry the epoch past
    :data:`CLEAR_EVERY` (the clear runs on the current stream, ahead of the
    replay).
    """
    global REPLAYED_SCANS
    entry = SCRATCH[(cuda_device_index(device), stream)]
    if entry.calls + n_scans > CLEAR_EVERY:
        entry.words[HEADER_WORDS:].zero_()
        entry.calls = 0
    entry.calls += n_scans
    REPLAYED_SCANS += n_scans


def empty_rows(n_leaves: int, n: int, device):
    """``n_leaves`` uninitialised int32[n] rows of one buffer, each starting
    on a 16-byte boundary (the kernel stores 16-byte words)."""
    buf = torch.empty((n_leaves, (n + 3) & ~3), dtype=torch.int32, device=device)
    return [buf[j, :n] for j in range(n_leaves)]


def _check(leaves, kinds):
    if not 1 <= len(leaves) <= MAX_LEAVES:
        raise ValueError(f"scan takes 1..{MAX_LEAVES} leaves, got {len(leaves)}")
    if len(kinds) != len(leaves):
        raise ValueError("one combine kind per leaf")
    for k in kinds:
        if k not in KINDS:
            raise ValueError(f"unknown combine kind {k!r}")
    n = leaves[0].shape[0]
    dev = leaves[0].device
    for x in leaves:
        if x.dtype != torch.int32 or x.dim() != 1 or x.shape[0] != n:
            raise TypeError("leaves must be 1-D int32 tensors of one length")
        if x.device != dev:
            raise ValueError("leaves must lie on one device")
    return n, dev


def scan_leaves_cuda(leaves, kinds, *, reverse: bool = False):
    """Launch the kernel on CUDA leaves (one launch of the wrapper), or
    record that launch when the current stream is capturing a graph."""
    global KERNEL_LAUNCHES, CAPTURED_CALLS
    leaves, kinds = list(leaves), tuple(kinds)
    n, dev = _check(leaves, kinds)
    if dev.type != "cuda":
        raise ValueError("scan_leaves_cuda takes CUDA tensors")
    if not all(x.is_contiguous() for x in leaves):
        raise ValueError("scan leaves must be contiguous")
    L = len(leaves)
    out = empty_rows(L, n, dev)
    if n == 0:
        return out
    lib = LIBRARY.load()
    index = cuda_device_index(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = scratch_for(dev, index, stream, scratch_words(L, n))
    code = 0
    for j, k in enumerate(kinds):
        code |= KINDS[k] << (2 * j)
    ins = [x.data_ptr() for x in leaves] + [None] * (MAX_LEAVES - L)
    outs = [x.data_ptr() for x in out] + [None] * (MAX_LEAVES - L)
    rc = lib.jt_scan_leaves(
        *ins, *outs, L, n, code, int(reverse), scratch.data_ptr(),
        scratch.numel(), index, stream,
    )
    if rc != 0:
        raise RuntimeError(f"scan kernel launch failed: CUDA error {rc}")
    if torch.cuda.is_current_stream_capturing():
        CAPTURED_CALLS += 1
    else:
        KERNEL_LAUNCHES += 1
    return out


def _scan_one_plain(x, kind):
    if kind == "max":
        return torch.cummax(x, 0).values
    if kind == "add":
        return torch.cumsum(x, 0, dtype=torch.int32)
    idx = torch.arange(x.shape[0], device=x.device)
    src = torch.cummax(torch.where(x >= 0, idx, -1), 0).values
    return torch.where(src >= 0, x.gather(0, src.clamp_min(0)), -1)


def scan_leaves_plain(leaves, kinds, *, reverse: bool = False):
    """The same scans in plain PyTorch, on any device."""
    leaves, kinds = list(leaves), tuple(kinds)
    _check(leaves, kinds)
    out = []
    for x, k in zip(leaves, kinds):
        if reverse:
            out.append(_scan_one_plain(x.flip(0), k).flip(0))
        else:
            out.append(_scan_one_plain(x, k))
    return out


def scan_leaves(leaves, kinds, *, reverse: bool = False):
    """Scan each int32[n] leaf with its combine kind.

    CUDA leaves go to the kernel (one launch); CPU leaves to the plain
    version. Returns a list of int32[n] tensors.
    """
    global PLAIN_CALLS
    leaves = list(leaves)
    _n, dev = _check(leaves, tuple(kinds))
    if dev.type == "cuda":
        return scan_leaves_cuda(leaves, kinds, reverse=reverse)
    if dev.type != "cpu":
        raise ValueError(f"no scan for device {dev}")
    PLAIN_CALLS += 1
    return scan_leaves_plain(leaves, kinds, reverse=reverse)
