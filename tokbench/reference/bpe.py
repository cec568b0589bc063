"""Plain byte-pair encoding over a ``.tiktoken`` rank file.

The yardstick that decides ``correct``: it reads the rank file by path,
pre-splits with :mod:`.presplit` and merges each piece that is not itself a
token by the rule of tiktoken's ``byte_pair_merge``: repeatedly merge the
adjacent pair whose bytes have the lowest rank, the leftmost of equal ranks,
until no adjacent pair is a token. The lowest pair is kept in a heap
(stale entries are skipped), which gives the same merges as tiktoken's
scan and keeps long pieces (CJK runs) from costing their square.
"""

from __future__ import annotations

import base64
import heapq
from typing import Dict, List, Optional

import numpy as np

from .presplit import SPLITTERS

_NONE = 1 << 62


def load_ranks(path: str) -> Dict[bytes, int]:
    """``base64(token) rank`` per line, as tiktoken writes them."""
    ranks: Dict[bytes, int] = {}
    with open(path, "rb") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if len(parts) != 2:
                raise ValueError(f"bad line in {path}: {line!r}")
            ranks[base64.b64decode(parts[0], validate=True)] = int(parts[1])
    return ranks


def merge(piece: bytes, ranks: Dict[bytes, int],
          limit: Optional[int] = None) -> List[int]:
    """Token ids of one piece by byte-pair merging; ``limit`` stops it after
    that many merges (the control's fault, never the yardstick's)."""
    n = len(piece)
    if n == 1:
        return [ranks[piece]]
    # part starts; a part runs to the next live start
    nxt = list(range(1, n + 2))
    prv = list(range(-1, n))
    live = [True] * (n + 1)
    rank = [_NONE] * (n + 1)
    heap = []

    def pair_rank(i):
        j = nxt[i]
        if j >= n:
            return _NONE
        return ranks.get(piece[i:nxt[j]], _NONE)

    for i in range(n - 1):
        r = ranks.get(piece[i:i + 2], _NONE)
        rank[i] = r
        if r != _NONE:
            heap.append((r, i))
    heapq.heapify(heap)
    merges = 0
    while heap and merges != limit:
        r, i = heapq.heappop(heap)
        if not live[i] or rank[i] != r:
            continue
        merges += 1
        j = nxt[i]
        live[j] = False
        nxt[i] = nxt[j]
        prv[nxt[j]] = i
        rank[i] = pair_rank(i)
        if rank[i] != _NONE:
            heapq.heappush(heap, (rank[i], i))
        p = prv[i]
        if p >= 0:
            rank[p] = pair_rank(p)
            if rank[p] != _NONE:
                heapq.heappush(heap, (rank[p], p))
    out = []
    i = 0
    while i < n:
        out.append(ranks[piece[i:nxt[i]]])
        i = nxt[i]
    return out


class Reference:
    """Encode and count with one encoding's ranks and pattern."""

    def __init__(self, vocab_file: str, pattern: str):
        self.ranks = load_ranks(vocab_file)
        self.split = SPLITTERS[pattern]
        self._token_bytes = None

    def encode(self, text: str, merge_limit: Optional[int] = None) -> List[int]:
        ranks = self.ranks
        out: List[int] = []
        for a, b in self.split(text):
            piece = text[a:b].encode("utf-8")
            r = ranks.get(piece)
            if r is not None:
                out.append(r)
            else:
                out.extend(merge(piece, ranks, merge_limit))
        return out

    def decode(self, ids: np.ndarray) -> bytes:
        """The bytes of a sequence of ids; an id that is no token raises
        ``IndexError``."""
        if self._token_bytes is None:
            size = max(self.ranks.values()) + 1
            lens = np.full(size, -1, np.int64)
            order = sorted(self.ranks.items(), key=lambda kv: kv[1])
            for tok, r in order:
                lens[r] = len(tok)
            offs = np.zeros(size, np.int64)
            offs[[r for _t, r in order]] = np.cumsum(
                [0] + [len(t) for t, _r in order[:-1]])
            pool = np.frombuffer(b"".join(t for t, _r in order), np.uint8)
            self._token_bytes = (lens, offs, pool)
        lens, offs, pool = self._token_bytes
        ids = np.asarray(ids, np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= len(lens)
                         or (lens[ids] < 0).any()):
            raise IndexError("an id that is no token")
        ln = lens[ids]
        total = int(ln.sum())
        # every byte's index in the pool: each token's offset, then a ramp
        starts = np.repeat(offs[ids] - np.concatenate(([0], np.cumsum(ln)[:-1])), ln)
        return pool[starts + np.arange(total)].tobytes()
