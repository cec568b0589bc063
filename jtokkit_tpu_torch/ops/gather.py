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
it must read and write 4 bytes per lookup plus the table once. The table
reaches shared memory by one asynchronous bulk copy while the threads
already load their first indices; :func:`launch_plan` picks the threads per
block and the grid from the table's size (see the note at the top of the
source).

The kernel is on no encode path: its caller is the profiling entry point
``python -m jtokkit_tpu_torch.scripts.profile_gather``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ._build import KernelLibrary, cuda_device_index

BLOCK_SHARED_BYTES = 232448  # the most shared memory one block can have
SM_SHARED_BYTES = 233472  # shared memory of one SM (228 KB) ...
BLOCK_RESERVED_BYTES = 1024  # ... of which every resident block costs 1 KB more
BARRIER_BYTES = 16  # the bulk copy's barrier, beside the table
SM_THREADS = 2048  # resident threads of one SM
MAX_TABLE = BLOCK_SHARED_BYTES // 4  # entries: one block's shared memory on sm_90
# longest table that leaves room for the barrier; a longer one goes by plain loads
MAX_BULK_TABLE = (BLOCK_SHARED_BYTES - BARRIER_BYTES) // 4
# 16-byte index vectors a thread is given when the grid is sized (the kernel
# loads up to four per trip; fewer per thread means more blocks in flight)
GRID_VECS_PER_THREAD = 2

# plain counters: wrapper launches of the kernel, and lookups that took the
# plain version because their tensors lay on the CPU
KERNEL_LAUNCHES = 0
PLAIN_CALLS = 0


def _declare(lib: ctypes.CDLL) -> None:
    vp = ctypes.c_void_p
    lib.jt_take_table.argtypes = [
        vp, ctypes.c_int, vp, vp, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, vp,
    ]
    lib.jt_take_table.restype = ctypes.c_int
    for fn in (lib.jt_take_table_max_entries, lib.jt_take_table_max_bulk_entries):
        fn.argtypes = []
        fn.restype = ctypes.c_int
    limits = (lib.jt_take_table_max_entries(), lib.jt_take_table_max_bulk_entries())
    if limits != (MAX_TABLE, MAX_BULK_TABLE):
        raise RuntimeError("the gather library's table limits differ from ops/gather.py")


LIBRARY = KernelLibrary("gather", _declare)


class LaunchPlan(NamedTuple):
    threads: int  # per block
    blocks: int
    bulk_bytes: int  # of the table by the asynchronous bulk copy; 0: plain loads
    n_vec: int  # 16-byte index vectors; 0: the scalar loop takes everything


def launch_plan(table_len: int, n: int, sms: int, *, table_aligned: bool = True,
                vectors: bool = True) -> LaunchPlan:
    """The kernel's launch for ``n`` lookups of a ``table_len``-entry table
    on a card of ``sms`` SMs.

    ``table_aligned``: the table's pointer is 16-byte aligned (else no bulk
    copy); ``vectors``: so are the indices' and the output's (else the scalar
    loop). Small tables get 256 threads and as many blocks as fill every SM's
    threads; a table that lets only a few blocks live on an SM gets up to
    1,024 threads a block.
    """
    table_bytes = 4 * table_len
    bulk_bytes = table_bytes & ~15 if table_aligned and table_len <= MAX_BULK_TABLE else 0
    shared = ((table_bytes + 15) & ~15) + BARRIER_BYTES if bulk_bytes else table_bytes
    by_shared = max(1, SM_SHARED_BYTES // (shared + BLOCK_RESERVED_BYTES))
    threads = 256
    while threads < 1024 and by_shared * threads * 2 <= SM_THREADS:
        threads *= 2
    resident = min(by_shared, SM_THREADS // threads)
    n_vec = n // 4 if vectors else 0
    work = n_vec or n
    blocks = -(-work // (threads * GRID_VECS_PER_THREAD))
    if blocks < sms:  # rather one vector a thread than SMs without a block
        blocks = min(sms, -(-work // threads))
    return LaunchPlan(threads, max(1, min(blocks, sms * resident)), bulk_bytes, n_vec)


_SM_COUNT: dict = {}  # device index -> SMs


def _sm_count(index: int) -> int:
    if index not in _SM_COUNT:
        _SM_COUNT[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SM_COUNT[index]


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
    index = cuda_device_index(dev)
    plan = launch_plan(
        table.shape[0], n, _sm_count(index),
        table_aligned=table.data_ptr() % 16 == 0,
        vectors=(idx.data_ptr() | out.data_ptr()) % 16 == 0,
    )
    rc = lib.jt_take_table(
        table.data_ptr(), table.shape[0], idx.data_ptr(), out.data_ptr(), n,
        plan.threads, plan.blocks, plan.bulk_bytes, plan.n_vec,
        index, torch.cuda.current_stream(dev).cuda_stream,
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
