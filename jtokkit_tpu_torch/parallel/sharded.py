"""Data-parallel sharded encode over ``torch.distributed``, one rank per
device.

Counterpart of ``jtokkit_tpu/parallel/sharded.py``. Every rank is called
with the same documents and assigns them to ranks by the reference's greedy
byte-balanced rule (whole documents, never split across ranks). Each rank
then runs its own single-device :class:`DeviceEngine` over its documents, so
everything the engine does (the warmed plan, the mapped count as graph
replays on the card, the native long-piece routing, the long-piece fallback)
holds per rank. The collectives:

- count: ONE ``all_reduce`` of a one-element int64 tensor on the engine's
  device, then one scalar read;
- encode: every rank's token ids and per-document counts in one int32
  tensor; one ``all_gather`` of the sizes, one of the tensors padded to the
  largest, and every rank rebuilds the full list (the reference's
  ``process_allgather``).

A document with a piece over 4096 bytes takes the engine's per-chunk
fallback on the rank that holds it; the reference sends its whole shard to
the single-chip engine instead. Outputs are identical.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..engine.device import CorpusPlan, DeviceEngine
from .mesh import data_group


class ShardedPlan(NamedTuple):
    """A corpus sharded over the group: the assignment (the same on every
    rank) and this rank's warmable plan of its own documents."""

    n_docs: int
    assign: list          # per-rank document indices, ascending
    plan: CorpusPlan      # this rank's documents, on its device


class ShardedTokenizer:
    """Data-parallel tokenizer for one encoding: this rank's share of every
    call runs on ``engine``."""

    def __init__(self, engine: DeviceEngine, group=None):
        self.engine = engine
        self.group = group if group is not None else data_group()
        self.n_dev = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        # collective calls of this tokenizer, by kind
        self.collectives = {"all_reduce": 0, "all_gather": 0}

    # ------------------------------------------------------------------

    def _shard_docs(self, texts: Sequence[Optional[str]]) -> List[List[int]]:
        """Greedy byte-balanced assignment of whole documents to ranks
        (the reference's ``_shard_docs``): longest first, each to the least
        loaded rank, then document order within each rank."""
        encoded = [(t.encode("utf-8") if t else b"") for t in texts]
        order = sorted(range(len(encoded)), key=lambda i: -len(encoded[i]))
        loads = [0] * self.n_dev
        assign: List[List[int]] = [[] for _ in range(self.n_dev)]
        for i in order:
            d = loads.index(min(loads))
            assign[d].append(i)
            loads[d] += len(encoded[i]) + 1
        for a in assign:
            a.sort()
        return assign

    def preload_corpus(self, texts: Sequence[Optional[str]]) -> ShardedPlan:
        """Shard the corpus and copy this rank's documents to its device
        once; the plan warms like :meth:`DeviceEngine.preload_corpus`'s."""
        assign = self._shard_docs(texts)
        mine = [texts[i] for i in assign[self.rank]]
        return ShardedPlan(len(texts), assign, self.engine.preload_corpus(mine))

    # ------------------------------------------------------------------

    def count_tokens_corpus(self, texts: Sequence[Optional[str]], plan=None) -> int:
        """Total token count over every rank: this rank's count (the mapped
        count over a warmed plan), ONE all_reduce, one scalar read."""
        if plan is None:
            plan = self.preload_corpus(texts or [])
        eng = self.engine
        dev_total, host_total = eng._count_parts(None, plan.plan)
        total = torch.full((1,), host_total, dtype=torch.int64, device=eng.device)
        if dev_total is not None:
            total += dev_total
        dist.all_reduce(total, group=self.group)
        self.collectives["all_reduce"] += 1
        return int(eng._read(total)[0])

    def encode_ordinary_batch_arrays(
        self, texts: Sequence[Optional[str]], plan=None
    ) -> List[np.ndarray]:
        """Token ids per document as int32 arrays, the same full list on
        every rank."""
        if plan is None:
            plan = self.preload_corpus(texts or [])
        eng = self.engine
        mine = plan.assign[self.rank]
        arrays = eng.encode_ordinary_batch_arrays(None, plan=plan.plan) if mine else []
        payload = np.concatenate(
            [np.asarray([len(a) for a in arrays], np.int32)] + list(arrays)
        ) if arrays else np.zeros(0, np.int32)
        sizes = self._all_gather(
            torch.tensor([len(payload)], dtype=torch.int64, device=eng.device)
        )
        sizes = [int(s) for s in eng._read(torch.cat(sizes))]
        padded = torch.zeros(max(max(sizes), 1), dtype=torch.int32)
        padded[: len(payload)] = torch.from_numpy(payload)
        gathered = eng._read(torch.stack(self._all_gather(padded.to(eng.device))))
        out: List[np.ndarray] = [np.zeros(0, np.int32)] * plan.n_docs
        for r, docs in enumerate(plan.assign):
            row = gathered[r]
            counts = row[: len(docs)]
            splits = len(docs) + np.cumsum(counts)
            for doc_idx, lo, hi in zip(docs, splits - counts, splits):
                out[doc_idx] = row[lo:hi]
        return out

    def encode_ordinary_batch(self, texts: Sequence[Optional[str]]) -> List[List[int]]:
        return [a.tolist() for a in self.encode_ordinary_batch_arrays(texts)]

    def _all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        out = [torch.empty_like(t) for _ in range(self.n_dev)]
        dist.all_gather(out, t, group=self.group)
        self.collectives["all_gather"] += 1
        return out
