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
- encode: every rank's token ids, gathered by ONE ``all_gather`` into one
  [world, largest rank's total] int32 tensor on the device, then ONE read
  into pinned host memory, split per document by the layout (every rank's
  token total and per-document counts). The layout is plan-stable and is
  gathered once per :class:`ShardedPlan`, at its first encode (one more
  ``all_gather`` and read). Over a warmed plan the rank's tokens never
  leave the device before the gather (:meth:`DeviceEngine.encode_plan_tokens`:
  on a card one graph replay per chunk); the reference fetches each shard's
  live token prefix from the device likewise and splits it by its counts.
  Tokens travel as int32: every rank unpacks every rank's tokens, and the
  16-bit halves would cost more host time than their bytes save.

A document with a piece over 4096 bytes takes the engine's per-chunk
fallback on the rank that holds it; the reference sends its whole shard to
the single-chip engine instead. Outputs are identical.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..engine.device import CorpusPlan, DeviceEngine
from .mesh import data_group


class ShardedPlan:
    """A corpus sharded over the group: the assignment (the same on every
    rank), this rank's warmable plan of its own documents and, from the
    first encode on, the layout and the gather's device buffers."""

    def __init__(self, n_docs: int, assign: list, plan: CorpusPlan):
        self.n_docs = n_docs
        self.assign = assign   # per-rank document indices, ascending
        self.plan = plan       # this rank's documents, on its device
        # per rank (token total, per-document counts), gathered once
        self.layout: Optional[List[Tuple[int, np.ndarray]]] = None
        self.send = None       # int32[largest total]: this rank's tokens, padded
        self.recv = None       # int32[world, largest total]: the gather's output


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
        dev_total, host_total, pending = eng._count_parts(None, plan.plan)
        total = torch.full((1,), host_total, dtype=torch.int64, device=eng.device)
        if dev_total is not None:
            total += dev_total
        dist.all_reduce(total, group=self.group)
        self.collectives["all_reduce"] += 1
        return int(eng._read(total, pending)[0])

    def encode_ordinary_batch_arrays(
        self, texts: Sequence[Optional[str]], plan=None
    ) -> List[np.ndarray]:
        """Token ids per document as int32 arrays, the same full list on
        every rank.

        The plan's first encode runs the engine's host-array encode (its
        cold pass, or the pass that caches the counts), uploads the rank's
        tokens and gathers the layout; every later pass keeps them on the
        device. Each pass then makes ONE ``all_gather`` of the tokens and
        ONE read."""
        if plan is None:
            plan = self.preload_corpus(texts or [])
        eng = self.engine
        counts: List[int] = []
        if not plan.assign[self.rank]:
            tokens = torch.zeros(0, dtype=torch.int32, device=eng.device)
        elif plan.layout is None:
            arrays = eng.encode_ordinary_batch_arrays(None, plan=plan.plan)
            counts = [len(a) for a in arrays]
            tokens = eng._upload(np.concatenate(arrays))
        else:
            tokens = eng.encode_plan_tokens(plan.plan)
        if plan.layout is None:
            self._gather_layout(plan, counts)
        n = plan.layout[self.rank][0]
        if tokens.shape[0] != n:
            raise RuntimeError(f"rank {self.rank}: {tokens.shape[0]} tokens, "
                               f"the layout holds {n}")
        plan.send[:n].copy_(tokens)
        self._all_gather(plan.send, list(plan.recv.unbind(0)))
        gathered = self._read_fresh(plan.recv)
        out: List[np.ndarray] = [np.zeros(0, np.int32)] * plan.n_docs
        for r, docs in enumerate(plan.assign):
            total, doc_counts = plan.layout[r]
            pieces = np.split(gathered[r, :total], np.cumsum(doc_counts)[:-1])
            for doc_idx, toks in zip(docs, pieces):
                out[doc_idx] = toks
        return out

    def _gather_layout(self, plan: ShardedPlan, counts: List[int]) -> None:
        """Gather every rank's token total and per-document counts (one
        ``all_gather`` of int64 rows and one read), cache them on the plan
        and make the token gather's buffers."""
        width = 1 + max(len(a) for a in plan.assign)
        row = torch.zeros(width, dtype=torch.int64)
        row[0] = sum(counts)
        row[1 : 1 + len(counts)] = torch.tensor(counts, dtype=torch.int64)
        row = row.to(self.engine.device)
        rows = self.engine._read(torch.stack(
            self._all_gather(row, [torch.empty_like(row) for _ in range(self.n_dev)])))
        plan.layout = [
            (int(rows[r, 0]), rows[r, 1 : 1 + len(docs)].copy())
            for r, docs in enumerate(plan.assign)
        ]
        largest = max(1, max(total for total, _c in plan.layout))
        dev = self.engine.device
        plan.send = torch.zeros(largest, dtype=torch.int32, device=dev)
        plan.recv = torch.empty((self.n_dev, largest), dtype=torch.int32, device=dev)

    def _read_fresh(self, t: torch.Tensor) -> np.ndarray:
        """ONE read of ``t`` into new host memory (pinned on a card), so the
        arrays split from it outlive the next pass."""
        eng = self.engine
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=eng.device.type == "cuda")
        host.copy_(t, non_blocking=True)
        eng._wait_fetches()
        return host.numpy()

    def encode_ordinary_batch(self, texts: Sequence[Optional[str]]) -> List[List[int]]:
        return [a.tolist() for a in self.encode_ordinary_batch_arrays(texts)]

    def _all_gather(self, t: torch.Tensor, out: List[torch.Tensor]) -> List[torch.Tensor]:
        dist.all_gather(out, t, group=self.group)
        self.collectives["all_gather"] += 1
        return out
