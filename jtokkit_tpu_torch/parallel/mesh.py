"""Process group helpers for data parallelism over ``torch.distributed``.

Counterpart of ``jtokkit_tpu/parallel/mesh.py``. The reference's only
parallelism is a JVM thread pool fanning files out (reference
``benchmark/.../AbstractMultiThreadedBenchmark.java:35-45``); here it is data
parallelism with one rank per device: corpus shards per rank, vocabulary
tables on every rank, counts reduced with ``all_reduce``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..engine.device import resolve_device


def initialize_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device=None,
) -> Optional[torch.device]:
    """Join the default process group; returns this rank's device.

    Does nothing (and returns None) when called with no arguments: a single
    process needs no group. Otherwise the backend follows ``device``: NCCL
    for a CUDA device (``None`` means the CUDA card, and without one this
    raises; a CUDA device without an index takes ``rank`` modulo the
    visible cards), gloo for ``device="cpu"``. ``init_method`` is a
    ``tcp://host:port`` or ``file://`` address.
    """
    if init_method is None and world_size is None and rank is None and device is None:
        return None
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", (rank or 0) % torch.cuda.device_count())
        torch.cuda.set_device(dev)  # before NCCL starts
        backend = "nccl"
    else:
        backend = "gloo"
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        **kwargs,
    )
    return dev


def data_group(ranks: Optional[Sequence[int]] = None):
    """The data-parallel group: every rank of the default group, or a new
    group over ``ranks``. Raises before :func:`initialize_distributed`."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call initialize_distributed(...) first"
        )
    return dist.group.WORLD if ranks is None else dist.new_group(list(ranks))
