"""Lookup of a small int32 table held in on-chip memory: the hand-written
CUDA kernel and its plain PyTorch version.

Replaces the TPU kernel of ``scripts/profile_gather.py`` (``main`` -> ``pal``:
``jnp.take(tbl, idx)`` with every operand in VMEM). ``take_table(table, idx)``
returns ``table[idx]`` with ``idx``'s shape; indices are clamped into the
table like :func:`..ops.classify.take_clip`, so nothing reads outside it.

A CUDA tensor goes to the kernel in ``csrc/gather.cu`` and nowhere else; a
CPU tensor goes to :func:`take_table_plain`. Every block of the kernel keeps
the whole table in shared memory, so the table is limited to
:data:`MAX_TABLE` entries (232,448 bytes, the most shared memory one block
can have on an H100); a longer table raises. The kernel is memory-bound:
it must read and write 4 bytes per lookup plus the table once.

The kernel is on no encode path: its caller is the profiling entry point
``python -m jtokkit_tpu_torch.scripts.profile_gather``.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import KernelLibrary, cuda_device_index

MAX_TABLE = 232448 // 4  # entries: one block's shared memory on sm_90

# plain counters: wrapper launches of the kernel, and lookups that took the
# plain version because their tensors lay on the CPU
KERNEL_LAUNCHES = 0
PLAIN_CALLS = 0


def _declare(lib: ctypes.CDLL) -> None:
    vp = ctypes.c_void_p
    lib.jt_take_table.argtypes = [
        vp, ctypes.c_int, vp, vp, ctypes.c_longlong, ctypes.c_int, vp,
    ]
    lib.jt_take_table.restype = ctypes.c_int
    lib.jt_take_table_max_entries.argtypes = []
    lib.jt_take_table_max_entries.restype = ctypes.c_int
    if lib.jt_take_table_max_entries() != MAX_TABLE:
        raise RuntimeError("the gather library's table limit differs from MAX_TABLE")


LIBRARY = KernelLibrary("gather", _declare)


def _check(table, idx):
    if table.dtype != torch.int32 or table.dim() != 1:
        raise TypeError("the table must be a 1-D int32 tensor")
    if idx.dtype != torch.int32:
        raise TypeError("indices must be int32")
    if table.shape[0] < 1:
        raise ValueError("the table is empty")
    if table.shape[0] > MAX_TABLE:
        raise ValueError(
            f"a table of {table.shape[0]} entries does not fit one block's "
            f"shared memory (at most {MAX_TABLE})"
        )
    if idx.device != table.device:
        raise ValueError("table and indices must lie on one device")
    return table.device


def take_table_cuda(table, idx):
    """Launch the kernel on CUDA tensors (one launch of the wrapper)."""
    global KERNEL_LAUNCHES
    dev = _check(table, idx)
    if dev.type != "cuda":
        raise ValueError("take_table_cuda takes CUDA tensors")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("table and indices must be contiguous")
    out = torch.empty(idx.shape, dtype=torch.int32, device=dev)
    n = idx.numel()
    if n == 0:
        return out
    lib = LIBRARY.load()
    rc = lib.jt_take_table(
        table.data_ptr(), table.shape[0], idx.data_ptr(), out.data_ptr(), n,
        cuda_device_index(dev), torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"gather kernel launch failed: CUDA error {rc}")
    KERNEL_LAUNCHES += 1
    return out


def take_table_plain(table, idx):
    """The same lookup in plain PyTorch, on any device."""
    _check(table, idx)
    flat = idx.reshape(-1).long().clamp(0, table.shape[0] - 1)
    return table.index_select(0, flat).reshape(idx.shape)


def take_table(table, idx):
    """``table[idx]`` (clamped) for an int32 table of at most
    :data:`MAX_TABLE` entries and int32 indices of any shape.

    CUDA tensors go to the kernel (one launch); CPU tensors to the plain
    version.
    """
    global PLAIN_CALLS
    dev = _check(table, idx)
    if dev.type == "cuda":
        return take_table_cuda(table, idx)
    if dev.type != "cpu":
        raise ValueError(f"no table lookup for device {dev}")
    PLAIN_CALLS += 1
    return take_table_plain(table, idx)
