"""The un-planned batch call streamed chunk by chunk
(``DeviceEngine._stream_stage_a``): the lazy chunk plan (the native chunk
packer) against the eager one it replaced, the answers of streamed calls
against the host oracle and a warmed plan's passes, the order in which
chunks are packed and their Stage A issued, the ``streamed_chunks``
counter, and the packer's split point against a full scan.

Engines run on the CPU (``device="cpu"``; the device calls with
``chunk_bytes=1<<17``); nothing here needs a card. The eager plan is the JAX
package's. Every comparison is exact (bytes and integer ids: tolerance 0).
"""

from collections.abc import Sequence

import numpy as np
import pytest
import torch

from jtokkit_tpu_torch import Encodings, EncodingType, pack
from jtokkit_tpu_torch.engine.device import _DOC_SIZES, CHUNK_BYTES, DeviceEngine, flat_sizes
from jtokkit_tpu_torch.utils import corpus

from . import pack_reference as ref

# The suite runs in several worker processes at once; torch's own thread
# pool in each of them would oversubscribe the cores.
torch.set_num_threads(1)

SMALL = 1 << 17
_ENGINES = {}


def _oracle():
    if "oracle" not in _ENGINES:
        _ENGINES["oracle"] = Encodings.new_lazy_encoding_registry(
            device="cpu").get_encoding(EncodingType.CL100K_BASE).oracle
    return _ENGINES["oracle"]


def engine(chunk_bytes=SMALL, **kw):
    """A CPU engine over cl100k, one per settings and test module."""
    key = (chunk_bytes, tuple(sorted(kw.items())))
    if key not in _ENGINES:
        _ENGINES[key] = DeviceEngine.from_oracle(
            _oracle(), device="cpu", chunk_bytes=chunk_bytes, **kw)
    return _ENGINES[key]


def full_scan_split(data: bytes, limit: int) -> int:
    """The split point by one scan of the whole window: the reference of
    the packer's search."""
    w = np.frombuffer(data[:limit], dtype=np.uint8)
    if len(w) < 2:
        return 0
    is_crlf = (w[1:] == 0x0A) | (w[1:] == 0x0D)
    prev = w[:-1]
    is_alnum = (((prev >= 0x30) & (prev <= 0x39)) | ((prev >= 0x41) & (prev <= 0x5A))
                | ((prev >= 0x61) & (prev <= 0x7A)))
    cand = np.flatnonzero(is_crlf & is_alnum)
    return int(cand[-1]) + 1 if len(cand) else 0


def eager_plan_chunks(eng, texts):
    """The chunk plan as it was before it streamed: every document of the
    batch encoded and cut (by the full scan) first, then packed; the JAX
    package's plan (``pack_reference.plan_chunks``). The lazy plan's
    reference."""
    return [c[:4] for c in ref.plan_chunks(texts, eng.chunk_bytes)]


def _wrapped(nbytes: int, seed: int) -> str:
    """About ``nbytes`` of English hard-wrapped at 12 words a line: a letter
    or digit before most line feeds, where the packer may cut."""
    words = " ".join(corpus.generate(nbytes / 1e6, seed=seed)).split(" ")
    lines = [" ".join(words[k : k + 12]) for k in range(0, len(words), 12)]
    return "\n".join(lines)[:nbytes]


def books(limit: int):
    """Books over a chunk, cut at safe points, beside shorter ones."""
    return [_wrapped(int(limit * 1.6), 1), _wrapped(limit // 3, 2),
            _wrapped(int(limit * 2.3), 3)]


def short_docs(limit: int):
    """About 2,000 short documents: many a chunk."""
    rng = np.random.default_rng(4)
    text = " ".join(corpus.generate(0.1, seed=5))
    lens = rng.integers(8, limit // 850, 2000)
    starts = rng.integers(0, len(text) - int(lens.max()), 2000)
    return [text[s : s + n] for s, n in zip(starts, lens)]


def empties(limit: int):
    """``None`` and empty documents, first, last and among the others."""
    rng = np.random.default_rng(6)
    text = _wrapped(limit // 4, 8)
    docs = []
    for _ in range(80):
        r = rng.random()
        n = int(rng.integers(limit // 50, limit // 8))
        start = int(rng.integers(0, len(text) - n))
        docs.append(None if r < 0.2 else "" if r < 0.4 else text[start : start + n])
    return [None, ""] + docs + ["", None]


def unsplittable(limit: int):
    """A document over a chunk with no safe split point (no line feed), one
    giant chunk of its own."""
    return ["before it", "word " * (limit // 5 + 300), "after it"]


BATCHES = {"books": books, "short": short_docs, "empties": empties,
           "unsplittable": unsplittable}


@pytest.mark.parametrize("chunk_bytes", [SMALL, CHUNK_BYTES])
@pytest.mark.parametrize("batch", list(BATCHES))
def test_lazy_plan_yields_the_eager_chunks(batch, chunk_bytes):
    """Chunk for chunk the same ``buf`` (and so the same flat size),
    ``doc_ends``, ``parts`` and ``ascii_only`` as planning the whole batch
    first."""
    eng = engine(chunk_bytes)
    texts = BATCHES[batch](chunk_bytes)
    got, want = list(eng._plan_chunks(texts)), list(eager_plan_chunks(eng, texts))
    assert len(got) == len(want) >= 2
    for k, ((b, d, p, a), (wb, wd, wp, wa)) in enumerate(zip(got, want)):
        assert b.dtype == wb.dtype and np.array_equal(b, wb), k
        assert d.dtype == wd.dtype and np.array_equal(d, wd), k
        assert (p, a) == (wp, wa), k
    if batch == "books":
        # a book was cut across chunks
        assert any(sum(i in p for _b, _d, p, _a in got) >= 2 for i in range(3))
    if batch == "unsplittable":
        assert any(len(b) > chunk_bytes for b, _d, _p, _a in got)


def routes():
    """One streamed batch whose chunks take every route: ok, a capacity
    retry kept on the device (120,000 one-byte pieces), the long-piece
    fallback (a 5,000-byte piece) and the native engine (a 1,800-byte CJK
    piece in a chunk of its own)."""
    filler = _wrapped(140_000, 7)
    return [
        filler[:100_000],
        "a1" * 60_000,
        ("a" * 5000 + " " + filler)[:130_000],
        "中文" * 300, None, "", "short tail",
    ]


@pytest.mark.parametrize("batch", list(BATCHES) + ["routes"])
def test_streamed_calls_equal_the_oracle_and_a_warmed_plan(batch):
    texts = routes() if batch == "routes" else BATCHES[batch](SMALL)
    eng = engine(native_long=(batch == "routes"))
    orc = eng.oracle
    want = [orc.encode_ordinary(t)[0] if t else [] for t in texts]
    before = (eng.capacity_retries, eng.fallback_chunks, eng.native_chunks)
    got = eng.encode_ordinary_batch_arrays(texts)
    assert [a.tolist() for a in got] == want
    routed = [a - b for a, b in zip(
        (eng.capacity_retries, eng.fallback_chunks, eng.native_chunks), before)]
    assert routed == ([1, 1, 1] if batch == "routes" else [0, 0, 0])
    counts = [len(w) for w in want]
    assert eng.count_tokens_batch(texts) == counts
    plan = eng.preload_corpus(texts)
    for _ in range(2):  # the plan's cold pass, then its warmed one
        assert [a.tolist() for a in eng.encode_ordinary_batch_arrays(None, plan=plan)] == want
    assert eng.count_tokens_corpus(None, plan=plan) == sum(counts)


class _Drawn(Sequence):
    """A batch that logs each document as the packer reads it."""

    def __init__(self, docs, events):
        self.docs, self.events = docs, events

    def __len__(self):
        return len(self.docs)

    def __getitem__(self, k):
        self.events.append(("doc", k))
        return self.docs[k]


@pytest.mark.parametrize("cold_cache", [False, True])
def test_each_chunk_is_issued_before_the_next_is_planned(cold_cache, monkeypatch):
    """Stage A of chunk k runs before the packer packs chunk k + 1 or reads
    any document past the one that did not fit in chunk k, on the eager
    path and from the graph cache."""
    eng = DeviceEngine.from_oracle(_oracle(), device="cpu", chunk_bytes=SMALL,
                                   cold_cache=cold_cache)
    events = []
    real_a, real_chunks = eng._stage_a, eng._chunks

    def stage_a(*args):
        events.append(("stage_a",))
        return real_a(*args)

    def chunks(texts, pin=False):
        for chunk in real_chunks(texts, pin):
            events.append(("build", chunk[2][-1]))
            yield chunk

    monkeypatch.setattr(eng, "_stage_a", stage_a)
    monkeypatch.setattr(eng, "_chunks", chunks)
    texts = short_docs(SMALL)
    n = len(list(eager_plan_chunks(eng, texts)))
    events.clear()
    eng.count_tokens_batch(_Drawn(texts, events))
    kinds = [e[0] for e in events if e[0] != "doc"]
    assert kinds == ["build", "stage_a"] * n
    # before a chunk's Stage A, the packer read no document past the one
    # after its last
    for k, e in enumerate(events):
        if e[0] == "stage_a":
            last = [x for x in events[:k] if x[0] == "build"][-1][1]
            assert max(x[1] for x in events[:k] if x[0] == "doc") <= last + 1
    # and it read them all, each chunk's from the cursor on
    assert {e[1] for e in events if e[0] == "doc"} == set(range(len(texts)))


def test_streamed_chunks_counts_all_but_the_last_of_an_unplanned_call():
    eng = engine()
    texts = books(SMALL)
    n = len(list(eng._plan_chunks(texts)))
    assert n >= 3
    for call in (eng.encode_ordinary_batch_arrays, eng.count_tokens_batch):
        before = eng.streamed_chunks
        call(texts)
        assert eng.streamed_chunks - before == n - 1
    # one chunk: nothing issued before the last chunk was planned
    before = eng.streamed_chunks
    eng.count_tokens_batch(["one chunk"])
    assert eng.streamed_chunks == before
    # a plan, cold and warmed, streams nothing
    plan = eng.preload_corpus(texts)
    for _ in range(2):
        eng.encode_ordinary_batch_arrays(None, plan=plan)
        eng.count_tokens_corpus(None, plan=plan)
    assert eng.streamed_chunks == before


# 64 KiB: the edges of windows of this size are among the split cases
WINDOW = 1 << 16


def _one_point(size: int, at: int, first: int = ord("a")) -> bytes:
    """``size`` bytes with one safe split point, at ``at``."""
    data = bytearray(b"." * size)
    data[at - 1], data[at] = first, 0x0A
    return bytes(data)


def first_piece(data: bytes, limit: int) -> int:
    """Bytes of the first chunk-document that the packer makes of one
    document (``data`` as UTF-8) in chunks of ``limit + 1`` bytes."""
    packer = pack.ChunkPacker([data.decode("utf-8")], limit + 1,
                              flat_sizes(limit + 1), _DOC_SIZES)
    _buf, doc_ends, _parts, _ascii, _last = next(packer)
    return int(doc_ends[0])


def packer_split(data: bytes, limit: int) -> int:
    """The packer's cut of ``data`` at ``limit``: the first piece's bytes
    for a document over the limit, 0 where it is not cut."""
    if len(data) <= limit:
        assert first_piece(data, limit) == len(data)
        return 0
    got = first_piece(data, limit)
    return 0 if got == len(data) else got


@pytest.mark.parametrize("seed", range(3))
def test_windowed_split_finds_the_full_scans_point(seed):
    """A document over ``chunk_bytes - 1`` bytes is cut where the full scan
    of its first ``limit`` bytes puts the last safe point: on random text of
    every density of split points (1- and 2-byte storage), and with the only
    point at each edge of a 16-byte block and of a 64 KiB window, at the
    first and last place it may be, and at a CR or after a digit or a
    capital; a document with no point is not cut, and one within the limit
    is not searched."""
    rng = np.random.default_rng(seed)
    alphabet = ["a", "b", "9", "Z", " ", "\n", "\r", ".", "\xe4", "\u0436"][: 9 + seed % 2]
    for _ in range(150):
        size, limit = (int(x) for x in rng.integers(1, 300_000, 2))
        density = rng.random() ** 6
        text = "".join(np.where(rng.random(size) < density,
                                rng.choice(alphabet, size), "x"))
        data = text.encode("utf-8")
        want = full_scan_split(data, limit) if len(data) > limit else 0
        assert packer_split(data, limit) == want
    limit = 3 * WINDOW + 77
    for win in (16, WINDOW):
        for at in (1, 2, limit - 1, limit - 1 - win, limit - win, limit - win + 1,
                   limit - 2 * win, 7):
            for first in (ord("a"), ord("7"), ord("Q")):
                data = _one_point(limit + 500, at, first)
                assert packer_split(data, limit) == full_scan_split(data, limit) == at
    cr = bytearray(_one_point(limit + 1, 5000))
    cr[5000] = 0x0D
    assert packer_split(bytes(cr), limit) == 5000
    # past the limit, or with nothing before it, there is no point
    assert packer_split(_one_point(limit + 10, limit), limit) == 0
    assert packer_split(b"\n" * 11, 10) == 0
