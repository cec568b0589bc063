"""The traffic generator: a ring of fresh batches of documents, from a seed.

One general generator for every traffic mix. A configuration file gives the
encoding and the documents' lengths (a lognormal, clipped); a traffic file
gives the batch size, the ring's least size and the scripts the documents
are written in, by count; a text file under ``text/`` gives a script's
statistics. Nothing here knows a cell.

Every seed gets the same batches by size and script (the stratified
quantiles of the length distribution, scripts dealt over the sorted
lengths, batches filled in one fixed order), in another order, and other
text: the seed changes which bytes the program sees and in what order, not
how much work a batch is. Text is
drawn by script from vectorised atoms (words, numbers, separators,
characters), so a ring of some hundreds of MiB takes seconds.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field
from statistics import NormalDist
from typing import List

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# bytes of phrases (sentences, runs) drawn per script and seed; documents
# are drawn from them, so the ring is built at the speed of a join
POOL_BYTES = 1 << 24
_BLOCK = 1 << 14  # phrases drawn per vectorised step


def load_text_spec(script: str, root: str = HERE) -> dict:
    with open(os.path.join(root, "text", f"{script}.json"), encoding="utf-8") as f:
        return json.load(f)


def rng_for(seed: int, purpose: int) -> np.random.Generator:
    """A generator for one purpose of one seed (any whole number)."""
    return np.random.default_rng([purpose, seed % (1 << 64)])


# ----------------------------------------------------------------------
# lengths and scripts: the same set for every seed
# ----------------------------------------------------------------------

def length_set(documents: dict, n: int) -> np.ndarray:
    """``n`` document lengths in bytes: the stratified quantiles of the
    clipped lognormal that ``documents`` gives, in increasing order."""
    z = NormalDist()
    mu, sigma = math.log(documents["median_bytes"]), documents["sigma"]
    q = [math.exp(mu + sigma * z.inv_cdf((k + 0.5) / n)) for k in range(n)]
    return np.clip(np.round(q), documents["min_bytes"],
                   documents["max_bytes"]).astype(np.int64)


def document_plan(documents: dict, traffic: dict):
    """(lengths, scripts) of the ring's documents before the seed orders
    them: enough bytes for ``ring_min_bytes`` and for ``ring_min_batches``
    full batches, so that every order fills at least that many batches.
    Scripts are dealt over the sorted lengths by their counts' pattern, so
    each script gets lengths from the whole distribution."""
    target = max(traffic["ring_min_bytes"],
                 traffic["ring_min_batches"] * traffic["batch_bytes"])
    # the mean from a trial set, then the least n that reaches the target
    n = max(1, math.ceil(target / length_set(documents, 4096).mean()))
    lengths = length_set(documents, n)
    while lengths.sum() < target:
        n = math.ceil(n * target / lengths.sum()) + 1
        lengths = length_set(documents, n)
    pattern = [s for s, k in traffic["scripts"].items() for _ in range(k)]
    scripts = np.array([pattern[i % len(pattern)] for i in range(n)])
    return lengths, scripts


# ----------------------------------------------------------------------
# text
# ----------------------------------------------------------------------

class _Atoms:
    """A table of byte strings, drawn by index and joined by one gather."""

    def __init__(self):
        self.items: List[bytes] = [b""]

    def add(self, items) -> int:
        base = len(self.items)
        self.items.extend(items)
        return base

    def freeze(self):
        self.len = np.array([len(b) for b in self.items], np.int64)
        self.off = np.concatenate(([0], np.cumsum(self.len)[:-1]))
        self.pool = np.frombuffer(b"".join(self.items), np.uint8)

    def join_rows(self, ids: np.ndarray) -> List[bytes]:
        """Each row of atom ids as one byte string."""
        rows = self.len[ids].sum(axis=1)
        ids = ids.reshape(-1)
        ln = self.len[ids]
        ids, ln = ids[ln > 0], ln[ln > 0]
        ends = np.cumsum(ln)
        idx = np.repeat(self.off[ids] - (ends - ln), ln) + np.arange(int(ends[-1]))
        raw = self.pool[idx].tobytes()
        cut = np.concatenate(([0], np.cumsum(rows))).tolist()
        return [raw[a:b] for a, b in zip(cut[:-1], cut[1:])]


def _sentences(spec: dict, wrap_rate: float):
    """A function (rng, s) -> ``s`` sentences of a ``sentences`` script."""
    a = _Atoms()
    space = a.add([b" ", b"\n", b"\n\n"])
    newline, blank = space + 1, space + 2
    words = [w.encode() for w in spec["words"]]
    contractions = [b""] + [c.encode() for c in spec["contractions"]]
    v, c = len(words), len(contractions)
    word_base = a.add([(w.capitalize() if cap else w) + x
                       for cap in (0, 1) for x in contractions for w in words])
    number_base = a.add([str(k).encode() for k in range(spec["number_below"])])
    punct_base = a.add([p.encode() for p in spec["punctuation"]])
    emoji_base = a.add([e.encode() + b" " for e in spec["emoji"]])
    cjk_base = a.add([ch.encode() for ch in spec["cjk_chars"]])
    a.freeze()
    lo, hi = spec["sentence_words"]
    run_lo, run_hi = spec["cjk_run"]

    def draw(rng, s):
        return a.join_rows(np.concatenate(columns(rng, s), axis=1))

    def columns(rng, s):
        n = rng.integers(lo, hi + 1, s)
        rows = np.arange(s)
        # word forms: (capitalised, contraction) of each word of the list
        form = np.zeros((s, hi), np.int64)
        form[:, 0] = (rng.random(s) < spec["capital_rate"]) * c
        has = rng.random(s) < spec["contraction_rate"]
        k = (rng.random(s) * n).astype(np.int64)
        form[rows[has], k[has]] += rng.integers(1, c, s)[has]
        ids = word_base + form * v + rng.integers(0, v, (s, hi))
        has = rng.random(s) < spec["number_rate"]
        k = (rng.random(s) * n).astype(np.int64)
        ids[rows[has], k[has]] = number_base + rng.integers(
            0, spec["number_below"], s)[has]
        j = np.arange(hi)[None, :]
        live = j < n[:, None]
        sep = np.where(rng.random((s, hi)) < wrap_rate, newline, space)
        sep = np.where(j == n[:, None] - 1,
                       punct_base + rng.integers(0, len(spec["punctuation"]), s)[:, None],
                       sep)
        cols = [np.stack([np.where(live, ids, 0), np.where(live, sep, 0)],
                         axis=2).reshape(s, 2 * hi)]
        if spec["emoji_rate"]:
            cols.append(np.where(rng.random(s) < spec["emoji_rate"], emoji_base
                                 + rng.integers(0, len(spec["emoji"]), s), 0)[:, None])
        if spec["cjk_rate"]:
            has = rng.random(s) < spec["cjk_rate"]
            m = rng.integers(run_lo, run_hi + 1, s)
            run = cjk_base + rng.integers(0, len(spec["cjk_chars"]), (s, run_hi))
            live = has[:, None] & (np.arange(run_hi)[None, :] < m[:, None])
            cols += [np.where(live, run, 0), np.where(has, space, 0)[:, None]]
        cols.append(np.where(rng.random(s) < spec["newline_rate"], newline, 0)[:, None])
        cols.append(np.where(rng.random(s) < spec["blank_line_rate"], blank, 0)[:, None])
        return cols

    return draw


def _runs(spec: dict):
    """A function (rng, s) -> ``s`` runs of a ``runs`` script, each closed
    by ``end`` (or ``other_end``)."""
    a = _Atoms()
    char_base = a.add([ch.encode() for ch in spec["chars"]])
    end = a.add([spec["end"].encode(), spec["other_end"].encode()])
    a.freeze()
    lo, hi = spec["run"]

    def draw(rng, s):
        m = rng.integers(lo, hi + 1, s)
        run = char_base + rng.integers(0, len(spec["chars"]), (s, hi))
        run = np.where(np.arange(hi)[None, :] < m[:, None], run, 0)
        close = np.where(rng.random(s) < spec["end_rate"], end, end + 1)
        return a.join_rows(np.concatenate([run, close[:, None]], axis=1))

    return draw


def phrase_pool(spec: dict, rng, wrap_rate: float = 0.0) -> List[bytes]:
    """At least :data:`POOL_BYTES` of sentences (or runs) of one script,
    drawn from its statistics."""
    draw = (_sentences(spec, wrap_rate) if spec["kind"] == "sentences"
            else _runs(spec))
    pool: List[bytes] = []
    size = 0
    while size < POOL_BYTES:
        more = draw(rng, _BLOCK)
        pool += more
        size += sum(map(len, more))
    return pool


def documents(pool: List[bytes], lengths: np.ndarray, rng, seen: set):
    """One document per length, in order: a stream of phrases drawn from
    ``pool`` is cut into documents that each start at a phrase and end at
    their length (cut back to the start of a character); the rest of the
    last phrase is dropped. A document equal to one in ``seen`` starts one
    phrase later. Returns the texts and their UTF-8 sizes."""
    plen = np.array([len(p) for p in pool], np.int64)
    need = int(lengths.sum() / plen.mean() * 1.1) + 2 * len(lengths) + 16
    ids = rng.integers(0, len(pool), need)
    # room for every document and for a redrawn start after each
    while plen[ids].sum() < lengths.sum() + 2 * plen.max() * len(lengths):
        ids = np.concatenate([ids, rng.integers(0, len(pool), need)])
    raw = b"".join(map(pool.__getitem__, ids.tolist()))
    ends = np.cumsum(plen[ids])
    starts = (ends - plen[ids]).tolist()
    texts, sizes = [], np.zeros(len(lengths), np.int64)
    k = 0  # the phrase the next document starts at
    for d, want in enumerate(lengths.tolist()):
        while True:
            if k >= len(starts):
                raise ValueError("the phrases ran out before every document was "
                                 "drawn once: too few distinct phrases")
            a = starts[k]
            b = a + want
            while (raw[b] & 0xC0) == 0x80:
                b -= 1
            doc = raw[a:b]
            if doc not in seen:
                break
            k += 1
        seen.add(doc)
        texts.append(doc.decode("utf-8"))
        sizes[d] = len(doc)
        # past the phrase the document ends in
        k = int(np.searchsorted(ends, b, side="left")) + 1
    return texts, sizes


# ----------------------------------------------------------------------
# the ring
# ----------------------------------------------------------------------

@dataclass
class Ring:
    batches: List[List[str]]
    batch_bytes: List[int]           # UTF-8 bytes of each batch
    doc_bytes: List[np.ndarray] = field(repr=False)  # per batch, per document
    scripts: List[List[str]] = field(repr=False)

    def __len__(self):
        return len(self.batches)


def batch_plan(lengths: np.ndarray, limit: int) -> List[np.ndarray]:
    """Document indices of each batch: whole documents in order, filled
    greedily up to ``limit`` bytes; the next document that does not fit
    starts the next batch."""
    starts, total = [0], 0
    for i, b in enumerate(lengths.tolist()):
        if total and total + b > limit:
            starts.append(i)
            total = 0
        total += b
    starts.append(len(lengths))
    return [np.arange(a, b) for a, b in zip(starts[:-1], starts[1:])]


def build_ring(config: dict, traffic: dict, seed: int, root: str = HERE) -> Ring:
    """The cell's ring of batches for ``seed``.

    The batches' make-up (which lengths and scripts travel together) is
    the same for every seed: the documents in one fixed order, filled
    greedily into batches of at most ``traffic["batch_bytes"]``. The seed
    orders the batches and the documents in each, and draws their text."""
    shape = config["documents"]
    lengths, scripts = document_plan(shape, traffic)
    fixed = rng_for(0, 0).permutation(len(lengths))
    groups = [fixed[g] for g in batch_plan(lengths[fixed], traffic["batch_bytes"])]
    rng = rng_for(seed, 1)
    groups = [groups[i][rng.permutation(len(groups[i]))]
              for i in rng.permutation(len(groups))]
    order = np.concatenate(groups)
    lengths, scripts = lengths[order], scripts[order]
    docs: List[str] = [""] * len(lengths)
    sizes = np.zeros(len(lengths), np.int64)
    seen: set = set()
    for k, script in enumerate(traffic["scripts"]):
        rng = rng_for(seed, 2 + k)
        pool = phrase_pool(load_text_spec(script, root), rng,
                           shape.get("wrap_rate", 0.0))
        at = np.flatnonzero(scripts == script)
        texts, sizes[at] = documents(pool, lengths[at], rng, seen)
        for i, d in zip(at.tolist(), texts):
            docs[i] = d
    ring = Ring([], [], [], [])
    a = 0
    for g in groups:
        b = a + len(g)
        ring.batches.append(docs[a:b])
        ring.batch_bytes.append(int(sizes[a:b].sum()))
        ring.doc_bytes.append(sizes[a:b])
        ring.scripts.append(list(scripts[a:b]))
        a = b
    return ring
