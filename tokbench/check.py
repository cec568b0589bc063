"""What decides ``correct``: the timed calls' own answers against the plain
reference.

The window keeps, through :class:`Answers`, of every call its sizes (ids
per document, or the counts), and whole the answers of a share of the
calls drawn from the seed and the first answer to each batch that holds a
script's longest document; the rest is let go as a caller lets go of what
it has used, so that the window's memory does not grow with its calls.
Three comparisons, each a count with the limit 0:

- ``repeat_mismatch``: calls whose answer differs from an earlier answer
  to the same batch of the ring (the window cycles the ring): by its sizes
  against the batch's first answer for every call, whole against the
  batch's first answer kept;
- ``roundtrip_mismatch`` (encode): documents of the first answer kept to
  each batch whose ids are no token or decode (by the reference's table)
  to other bytes than the document's;
- ``reference_mismatch``: documents of a sample of the answers kept whose
  ids (or count) differ from the reference's. The sample holds, for each
  script of the ring, the answer with its longest document, and one more
  answer drawn from the seed.

``malformed`` counts calls whose answer is not one array (or int) per
document. ``reference_docs`` must be at least 1, and
``reference_scripts`` (the scripts among the documents compared) at least
the number of scripts in the ring. The reference runs after the window, in
this process (no worker processes: nothing is left behind, and the check
takes some seconds, under the window's length).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .reference import Reference
from .ring import Ring, rng_for

# answers of the sample besides the longest document's of each script
SAMPLE_BATCHES = 1
# share of the calls whose answers the window keeps whole
KEEP_SHARE = 1 / 8


def digest(kind: str, ans) -> Optional[tuple]:
    """The sizes of an answer: the ids of each document (encode), or the
    counts; None for an answer that has none, such as an exception."""
    try:
        return tuple(ans) if kind == "count" else tuple(map(len, ans))
    except TypeError:
        return None


def longest_batches(ring: Ring) -> set:
    """The batches that hold each script's longest document (the lowest
    index among equals)."""
    out = set()
    for script in sorted({s for x in ring.scripts for s in x}):
        out.add(max(range(len(ring)), key=lambda b: (max(
            (n for n, s in zip(ring.doc_bytes[b].tolist(), ring.scripts[b])
             if s == script), default=-1), -b)))
    return out


class Answers:
    """What the window keeps of its calls' answers, in call order."""

    def __init__(self, kind: str, seed: int, longest: set = frozenset()):
        self.kind = kind
        self._rng = rng_for(seed, 101)
        self._longest = set(longest)
        self.first: Dict[int, int] = {}     # batch -> its first call
        self.kept: Dict[int, object] = {}   # call -> its whole answer
        self.digests: List[Optional[tuple]] = []

    def add(self, b: int, ans) -> None:
        c = len(self.digests)
        self.digests.append(digest(self.kind, ans))
        first = b not in self.first
        if first:
            self.first[b] = c
        if ((first and b in self._longest) or isinstance(ans, BaseException)
                or self._rng.random() < KEEP_SHARE):
            self.kept[c] = ans

    def tokens(self, c: int) -> int:
        """Ids (or the counts' sum) of call ``c``'s answer; 0 without one."""
        return sum(self.digests[c] or ())


@dataclass
class Checks:
    numbers: Dict[str, Tuple[int, str, int]] = field(default_factory=dict)
    failed_calls: int = 0

    def add(self, name: str, value: int, op: str, limit: int) -> None:
        self.numbers[name] = (int(value), op, limit)

    @property
    def passed(self) -> bool:
        return all(v <= lim if op == "max" else v >= lim
                   for v, op, lim in self.numbers.values())

    def as_json(self) -> dict:
        return {k: {"value": v, op: lim} for k, (v, op, lim) in self.numbers.items()}

    def lines(self) -> List[str]:
        return [f"check {k}: {v} ({'<=' if op == 'max' else '>='} {lim})"
                for k, (v, op, lim) in self.numbers.items()]


def _well_formed(kind: str, out, n_docs: int) -> bool:
    if not isinstance(out, list) or len(out) != n_docs:
        return False
    if kind == "count":
        return all(isinstance(x, int) for x in out)
    return all(isinstance(x, np.ndarray) and x.ndim == 1
               and np.issubdtype(x.dtype, np.integer) for x in out)


def _same(kind: str, a, b) -> bool:
    if kind == "count":
        return a == b
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def sample(ring: Ring, batches: List[int], calls: List[int], seed: int) -> List[int]:
    """The calls among ``calls`` (each kept whole; ``batches[c]`` the ring
    index call ``c`` sent) whose answers the reference checks: for each
    script, one with its longest document, and :data:`SAMPLE_BATCHES` more
    of other batches drawn from the seed."""
    picked = {}
    for script in sorted({s for c in calls for s in ring.scripts[batches[c]]}):
        def longest(c):
            b = batches[c]
            sizes = [n for n, s in zip(ring.doc_bytes[b].tolist(), ring.scripts[b])
                     if s == script]
            return (max(sizes, default=-1), -b, -c)
        c = max(calls, key=longest)
        picked[batches[c]] = c
    rest = sorted({batches[c]: c for c in reversed(calls)
                   if batches[c] not in picked}.items())
    k = min(SAMPLE_BATCHES, len(rest))
    if k:
        for i in rng_for(seed, 100).choice(len(rest), k, replace=False).tolist():
            picked[rest[i][0]] = rest[i][1]
    return sorted(picked.values())


def check(ring: Ring, batches: List[int], answers: Answers, seed: int,
          vocab_file: str, pattern: str) -> Checks:
    """Judge the window's calls: ``batches[c]`` is the ring index call
    ``c`` sent, ``answers`` what the window kept of its answers."""
    kind = answers.kind
    out = Checks()
    whole: Dict[int, object] = {}   # batch -> its first well-formed answer kept
    good: List[int] = []            # calls kept whole and well formed
    bad_batches = set()
    bad_call = [False] * len(batches)
    malformed = repeat = 0
    for c, b in enumerate(batches):
        d = answers.digests[c]
        ans = answers.kept.get(c)
        if (d is None or len(d) != len(ring.batches[b])
                or (c in answers.kept and not _well_formed(kind, ans, len(d)))):
            malformed += 1
            bad_call[c] = True
            continue
        if d != answers.digests[answers.first[b]] or (
                c in answers.kept and b in whole and not _same(kind, whole[b], ans)):
            repeat += 1
            bad_call[c] = True
        elif c in answers.kept:
            whole.setdefault(b, ans)
            good.append(c)
    out.add("malformed", malformed, "max", 0)
    out.add("repeat_mismatch", repeat, "max", 0)

    ref = Reference(vocab_file, pattern)
    if kind == "encode":
        roundtrip = 0
        # later answers kept are equal to their batch's first (above)
        for b, ans in whole.items():
            for text, ids in zip(ring.batches[b], ans):
                try:
                    ok = ref.decode(ids) == text.encode("utf-8")
                except IndexError:
                    ok = False
                if not ok:
                    roundtrip += 1
                    bad_batches.add(b)
        out.add("roundtrip_mismatch", roundtrip, "max", 0)

    mismatch = n_docs = 0
    scripts = set()
    for c in sample(ring, batches, good, seed) if good else []:
        b = batches[c]
        for text, script, ans in zip(ring.batches[b], ring.scripts[b], answers.kept[c]):
            ids = ref.encode(text)
            want = len(ids) if kind == "count" else np.asarray(ids, np.int32)
            n_docs += 1
            scripts.add(script)
            if not _same(kind, [ans], [want]):
                mismatch += 1
                bad_batches.add(b)
    out.add("reference_mismatch", mismatch, "max", 0)
    out.add("reference_docs", n_docs, "min", 1)
    out.add("reference_scripts", len(scripts), "min",
            len({s for x in ring.scripts for s in x}))
    out.failed_calls = sum(bad or b in bad_batches
                           for bad, b in zip(bad_call, batches))
    return out
