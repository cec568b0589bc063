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
7.5 us at the H100's 3.35 TB/s). Its reduce-then-scan design reads the input
twice and relies on L2 to keep the second read off device memory; see the
note at the top of the source.

The library is built and loaded by :mod:`._build` at the first launch.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import KernelLibrary, cuda_device_index

MAX_LEAVES = 4
KINDS = {"max": 0, "last": 1, "add": 2}

# plain counters: wrapper launches of the kernel, and scans that took the
# plain version because their tensors lay on the CPU
KERNEL_LAUNCHES = 0
PLAIN_CALLS = 0


def _declare(lib: ctypes.CDLL) -> None:
    vp = ctypes.c_void_p
    lib.jt_scan_leaves.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, vp,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, vp, ctypes.c_int, vp,
    ]
    lib.jt_scan_leaves.restype = ctypes.c_int
    lib.jt_scan_scratch_ints.argtypes = [ctypes.c_int, ctypes.c_longlong]
    lib.jt_scan_scratch_ints.restype = ctypes.c_longlong


LIBRARY = KernelLibrary("scan", _declare)


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
    """Launch the kernel on CUDA leaves (one launch of the wrapper)."""
    global KERNEL_LAUNCHES
    leaves, kinds = list(leaves), tuple(kinds)
    n, dev = _check(leaves, kinds)
    if dev.type != "cuda":
        raise ValueError("scan_leaves_cuda takes CUDA tensors")
    if not all(x.is_contiguous() for x in leaves):
        raise ValueError("scan leaves must be contiguous")
    L = len(leaves)
    out = torch.empty((L, n), dtype=torch.int32, device=dev)
    if n == 0:
        return list(out.unbind(0))
    lib = LIBRARY.load()
    scratch = torch.empty(
        (max(int(lib.jt_scan_scratch_ints(L, n)), 1),),
        dtype=torch.int32, device=dev,
    )
    code = 0
    for j, k in enumerate(kinds):
        code |= KINDS[k] << (2 * j)
    ins = [x.data_ptr() for x in leaves] + [None] * (MAX_LEAVES - L)
    outs = [out[j].data_ptr() for j in range(L)] + [None] * (MAX_LEAVES - L)
    rc = lib.jt_scan_leaves(
        *ins, *outs, L, n, code, int(reverse), scratch.data_ptr(),
        cuda_device_index(dev),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"scan kernel launch failed: CUDA error {rc}")
    KERNEL_LAUNCHES += 1
    return list(out.unbind(0))


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
