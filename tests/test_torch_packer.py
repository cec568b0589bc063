"""The native chunk packer (``jtokkit_tpu_torch/pack.py``, ``csrc/pack.cc``)
against the JAX package's chunk plan (``tests/pack_reference.py``): chunk
for chunk the same ``buf`` (bytes, size and padding), ``doc_ends``,
``parts``, ``ascii_only`` and end of batch, over small rings of the
benchmark's three configurations and over edge cases (empty and ``None``
documents, documents at the chunk limit, long documents with and without
safe split points, every ``str`` storage kind, multi-byte characters at the
limit, tuple and other batches, tiny chunks); errors as ``str.encode``
raises them; the ``wide_docs`` counter; one packer for plans and streamed
calls; a failed build that raises; no store past the block; and the builds
for hosts with and without SSE4.1.

Nothing here needs a card; every comparison is exact.
"""

import ctypes
import json
import os

import numpy as np
import pytest
import torch

from jtokkit_tpu_torch import Encodings, EncodingType, native, pack
from jtokkit_tpu_torch.engine.device import _DOC_SIZES, DeviceEngine, flat_sizes
from tokbench import ring

from . import pack_reference as ref

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = 1 << 17
_ENGINES = {}


def engine(chunk_bytes=SMALL):
    if chunk_bytes not in _ENGINES:
        oracle = Encodings.new_lazy_encoding_registry(device="cpu").get_encoding(
            EncodingType.CL100K_BASE).oracle
        _ENGINES[chunk_bytes] = DeviceEngine.from_oracle(
            oracle, device="cpu", chunk_bytes=chunk_bytes)
    return _ENGINES[chunk_bytes]


def packed(texts, chunk_bytes):
    """The packer's chunks as numpy arrays: (buf, doc_ends, parts,
    ascii_only, last) each."""
    packer = pack.ChunkPacker(texts, chunk_bytes, flat_sizes(chunk_bytes), _DOC_SIZES)
    return [(b.numpy().copy(), d.numpy().copy(), p, a, last)
            for b, d, p, a, last in packer]


def assert_same(got, texts, chunk_bytes):
    want = list(ref.plan_chunks(texts, chunk_bytes))
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g[0].dtype == w[0].dtype and np.array_equal(g[0], w[0]), k
        assert g[1].dtype == w[1].dtype and np.array_equal(g[1], w[1]), k
        assert g[2] == w[2], k
        assert type(g[3]) is bool and g[3] == w[3], k
        assert g[4] == w[4], k


# ----------------------------------------------------------------------
# the benchmark's configurations
# ----------------------------------------------------------------------

CONFIGS = {"cl100k-books": "encode", "r50k-web": "encode",
           "cl100k-culturax": "culturax-encode"}


def small_ring(config_name: str, seed: int):
    """A configuration's ring cut to batches of 384 KiB and documents of at
    most 96 KiB (books stay hard-wrapped and over a small chunk)."""
    with open(os.path.join(REPO, "tokbench", "configs", f"{config_name}.json")) as f:
        config = json.load(f)
    with open(os.path.join(REPO, "tokbench", "traffic",
                           f"{CONFIGS[config_name]}.json")) as f:
        traffic = json.load(f)
    d = config["documents"]
    d.update(median_bytes=min(d["median_bytes"], 24 * 1024),
             min_bytes=min(d["min_bytes"], 4096), max_bytes=96 * 1024)
    traffic.update(batch_bytes=384 * 1024, ring_min_batches=2,
                   ring_min_bytes=768 * 1024)
    return ring.build_ring(config, traffic, seed, os.path.join(REPO, "tokbench"))


@pytest.mark.parametrize("seed", [7, 2**31 + 5])
@pytest.mark.parametrize("config_name", list(CONFIGS))
def test_packer_equals_the_reference_on_rings(config_name, seed):
    """Every batch of a small ring, in chunks of 4 KiB (books and long web
    documents cut at safe points) and of 128 KiB, through the packer and
    through the engine's plan."""
    rg = small_ring(config_name, seed)
    assert len(rg.batches) >= 2
    for batch in rg.batches:
        for chunk_bytes in (1 << 12, SMALL):
            assert_same(packed(batch, chunk_bytes), batch, chunk_bytes)
        got = [(b, d, p, a, False) for b, d, p, a in engine()._plan_chunks(batch)]
        if got:
            got[-1] = got[-1][:4] + (True,)
        assert_same(got, batch, SMALL)


# ----------------------------------------------------------------------
# edge cases
# ----------------------------------------------------------------------

def _lines(n_bytes: int, end: str = "\n", word: str = "word") -> str:
    """About ``n_bytes`` of lines of words, a letter before each ``end``."""
    line = " ".join([word] * 6) + end
    return (line * (n_bytes // len(line.encode("utf-8")) + 1))


def _at_the_limit(cb: int):
    """Documents of cb - 1, cb and cb + 1 bytes alone and after others, with
    and without safe points."""
    docs = []
    for n in (cb - 1, cb, cb + 1):
        docs += ["x" * n, ("ab\n" * cb)[:n], "y", ("cd\r" * cb)[:n]]
    return docs


def _straddles(cb: int):
    """Multi-byte characters at every offset around the limit, alone and
    after a short document, with safe points before them."""
    docs = []
    for ch in ("é", "ж", "中", "😀"):
        for pad in range(cb - 6, cb + 2):
            docs.append("a" * pad + ch * 3 + "b\n" + ch * 2)
            docs.append("q" + "a\n" * (pad // 2) + ch + "c\n" + ch * (cb // 2))
    return docs


def _storage_kinds(n: int):
    """Long documents of every str storage: ASCII, 1 byte (é), 2 bytes
    (Cyrillic, CJK), 4 bytes (emoji), with line feeds and carriage returns
    after letters and after the wide characters."""
    return [
        _lines(n), _lines(n, word="café"), _lines(n, "\r", "привет"),
        _lines(n, word="中文字符"), _lines(n, word="a😀b"),
        "中" * n, "😀" * (n // 2) + "z\n" + "😀" * (n // 2),
        ("ж1\r\n" * n)[: 3 * n], "é" * n + "e\n" + "é" * 10, None, "",
    ]


EDGES = {
    "empty_batch": ([], 64),
    "none_and_empty": ([None, "", None], 64),
    "none_and_empty_among_others": ([None, "a", "", None, "bb", "", "c" * 70, None], 16),
    "at_the_limit_64": (_at_the_limit(64), 64),
    "at_the_limit_8192": (_at_the_limit(8192), 8192),
    "long_no_safe_point": (["head", "word " * 500, "x" * 300, "tail"], 64),
    "long_lf": ([_lines(5000), "mid", _lines(900)], 256),
    "long_cr": ([_lines(5000, "\r"), _lines(900, "\r\n")], 256),
    "points_after_digits_capitals": (["A1\n" * 400 + "-\n" * 50, "Z\r" * 300], 128),
    "storage_kinds": (_storage_kinds(3000), 1024),
    "storage_kinds_big_chunks": (_storage_kinds(20000), SMALL),
    "straddles_16": (_straddles(16), 16),
    "straddles_64": (_straddles(64), 64),
    "tuple_batch": (tuple(_storage_kinds(300)), 128),
    "chunk_2": (["a", "", "bc", "d\ne", None, "é", "ж\n", "中"], 2),
    "chunk_4": (["ab\ncd\n", "中\n中", "😀", "a\r", "xyz", ""], 4),
    "chunk_16": (_storage_kinds(40) + _at_the_limit(16), 16),
    "nul_characters": (["a\x00b", "\x00" * 40, "ж\x00" * 30, "\x00\n" * 20], 32),
}


@pytest.mark.parametrize("case", list(EDGES))
def test_packer_equals_the_reference_on_edge_cases(case):
    texts, chunk_bytes = EDGES[case]
    got = packed(texts, chunk_bytes)
    assert_same(got, texts, chunk_bytes)
    if case == "empty_batch":
        assert got == []
    if case == "long_no_safe_point":
        # the document with no safe point is a chunk of its own, over the limit
        assert any(len(b) > chunk_bytes for b, *_ in got)


@pytest.mark.parametrize("seed", range(3))
def test_packer_equals_the_reference_on_random_batches(seed):
    """Random batches of random text over an alphabet of every storage
    kind, line ends and the characters at the edges of each UTF-8 length,
    at chunk sizes from 2 bytes to 128 KiB."""
    rng = np.random.default_rng(seed)
    alphabet = np.array(["a", "Z", "9", " ", "\n", "\r", ".", "\x00", "\x7f",
                         "\x80", "é", "\xff", "ł", "ж", "߿", "ࠀ", "中",
                         "�", "￿", "\U00010000", "😀", "\U0010ffff"])
    for _ in range(150):
        chunk_bytes = int(rng.choice([2, 4, 16, 100, 1024, 8192, SMALL]))
        texts = []
        for _ in range(int(rng.integers(0, 10))):
            r = rng.random()
            if r < 0.1:
                texts.append(None if r < 0.05 else "")
                continue
            sub = rng.choice(alphabet, int(rng.integers(1, len(alphabet) + 1)),
                             replace=False)
            n = int(rng.exponential(chunk_bytes * rng.choice([0.2, 1, 3])))
            p = rng.random(len(sub))
            texts.append("".join(rng.choice(sub, n, p=p / p.sum())))
        if rng.random() < 0.2:
            texts = tuple(texts)
        assert_same(packed(texts, chunk_bytes), texts, chunk_bytes)


def test_any_iterable_batch_is_packed_as_a_list():
    docs = ["one\n" * 30, None, "два", "三"]
    want = packed(docs, 16)
    for batch in (iter(docs), (d for d in docs), tuple(docs)):
        got = packed(batch, 16)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])
            assert g[2:] == w[2:]


# ----------------------------------------------------------------------
# errors and items that are not str
# ----------------------------------------------------------------------

@pytest.mark.parametrize("at", [0, 1, 40])
def test_lone_surrogate_raises_as_str_encode(at):
    """A str holding a lone surrogate raises the UnicodeEncodeError that its
    ``encode("utf-8")`` raises, when the packing reaches it (in the first
    chunk or a later one), in the packer and in the engine's calls."""
    bad = "ab" + "\ud800" + "c" if at != 40 else "ж" * 30 + "\udfff"
    texts = ["x" * 10] * at + [bad, "after"]
    with pytest.raises(UnicodeEncodeError) as want:
        bad.encode("utf-8")
    with pytest.raises(UnicodeEncodeError) as got:
        packed(texts, 64)
    assert str(got.value) == str(want.value)
    eng = engine()
    for call in (eng.count_tokens_batch, eng.encode_ordinary_batch_arrays,
                 eng.preload_corpus):
        with pytest.raises(UnicodeEncodeError):
            call(texts)


class _Str(str):
    pass


class _Encodes(str):
    def encode(self, *args):
        return b"XY\xc3\xa9"


class _Returns:
    def encode(self, *args):
        return "not bytes"


def test_items_that_are_not_str_are_encoded_as_before():
    """Falsy items are empty documents; a str subclass and numpy's str go
    through their own ``encode``; bytes and numbers fail as their missing
    ``encode`` fails; an ``encode`` that returns no bytes is a TypeError."""
    texts = ["a", 0, False, b"", [], _Str("héllo\n" * 9), _Encodes("ignored"),
             np.str_("жж"), "b"]
    assert_same(packed(texts, 32), texts, 32)
    for item in (b"abc", 7, 2.5):
        with pytest.raises(AttributeError) as want:
            item.encode("utf-8")
        with pytest.raises(AttributeError) as got:
            packed(["ok", item], 64)
        assert str(got.value) == str(want.value)
    with pytest.raises(TypeError):
        packed([_Returns()], 64)


# ----------------------------------------------------------------------
# the counter, one packer, the build
# ----------------------------------------------------------------------

def test_wide_docs_counts_documents_read_from_non_ascii_storage():
    """``engine.wide_docs``: 0 for an ASCII batch; one a document read from
    1-, 2- or 4-byte storage, once however many chunks it spans, and not
    for a document that does not fit until the next chunk reads it."""
    eng = engine(1 << 12)
    before = eng.wide_docs
    eng.count_tokens_batch(["plain", None, "", _lines(20000), "ascii\n" * 9])
    assert eng.wide_docs == before
    wide = ["é", "жжж", "中文" * 900, "a😀", _lines(30000, word="café")]
    texts = ["x" * 4000] + wide[:2] + ["y" * 3000, None] + wide[2:] + ["z"]
    chunks = list(eng._plan_chunks(texts))
    assert len(chunks) >= 5
    assert eng.wide_docs == before + len(wide)
    eng.count_tokens_batch(texts)
    assert eng.wide_docs == before + 2 * len(wide)


def test_plans_and_streamed_calls_share_the_packer(monkeypatch):
    """``preload_corpus`` (through ``_plan_chunks``) and the un-planned
    calls (through ``_stream_stage_a``) each pack with one
    ``pack.ChunkPacker``; no other packing runs."""
    made = []

    class Counted(pack.ChunkPacker):
        def __init__(self, *args, **kw):
            made.append(args[1])
            super().__init__(*args, **kw)

    monkeypatch.setattr(pack, "ChunkPacker", Counted)
    eng = engine()
    texts = ["one", "два", None, _lines(300_000)]
    plan = eng.preload_corpus(texts)
    assert len(made) == 1 and len(plan) >= 3
    eng.count_tokens_batch(texts)
    eng.encode_ordinary_batch_arrays(texts)
    assert made == [SMALL] * 3


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """A packer source that does not compile raises with the compiler's
    output; nothing falls back."""
    bad = tmp_path / "pack.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(pack, "SOURCE", str(bad))
    with pytest.raises(RuntimeError, match="failed to build the chunk packer"):
        pack.build(force=True)


_BUILDS = {}


def build_for(march: str, tmp_path_factory) -> ctypes.PyDLL:
    """The packer built for ``-march=<march>`` (``native``: the engine's own
    build), once a test session."""
    if march == "native":
        return pack._load()
    if march not in _BUILDS:
        flags = [f"-march={march}" if f == "-march=native" else f for f in pack.CXX_FLAGS]
        path = str(tmp_path_factory.mktemp("pack") / f"libpack_{march}.so")
        native.compile_library(path, pack.SOURCE, flags, f"the chunk packer for {march}")
        lib = ctypes.PyDLL(path)
        pack.declare(lib)
        _BUILDS[march] = lib
    return _BUILDS[march]


@pytest.mark.parametrize("march", ["x86-64-v2", "x86-64"])
def test_every_build_of_the_packer_equals_the_reference(march, tmp_path_factory,
                                                        monkeypatch):
    """The packer's SSE blocks (``-march=x86-64-v2``) and its plain
    character loop (``-march=x86-64``), the builds of hosts with and without
    SSE4.1, on the edge cases and on random batches."""
    monkeypatch.setattr(pack, "_lib", build_for(march, tmp_path_factory))
    for case in EDGES.values():
        texts, chunk_bytes = case
        assert_same(packed(texts, chunk_bytes), texts, chunk_bytes)
    test_packer_equals_the_reference_on_random_batches(3)


GUARD = 64


def pack_exact_block(lib, texts, chunk_bytes: int):
    """One call of the packer into a block of exactly ``chunk_bytes`` bytes
    followed by ``GUARD`` guard bytes of 0xA5: (documents, block, guard,
    bytes written)."""
    mem = np.full(chunk_bytes + GUARD, 0xA5, dtype=np.uint8)
    cursor, result = np.zeros(3, dtype=np.int64), np.zeros(8, dtype=np.int64)
    ends = np.empty(chunk_bytes + 1, dtype=np.int32)
    parts = np.empty(chunk_bytes + 1, dtype=np.int32)
    sizes = np.asarray(flat_sizes(chunk_bytes), dtype=np.int64)
    doc_sizes = np.asarray(_DOC_SIZES, dtype=np.int64)
    n = lib.jt_pack_chunk(texts, cursor.ctypes.data, mem.ctypes.data, chunk_bytes,
                          ends.ctypes.data, parts.ctypes.data, chunk_bytes,
                          sizes.ctypes.data, len(sizes), doc_sizes.ctypes.data,
                          len(doc_sizes), result.ctypes.data)
    return n, mem[:chunk_bytes], mem[chunk_bytes:], int(result[0])


@pytest.mark.parametrize("march", ["native", "x86-64-v2", "x86-64"])
def test_no_store_reaches_past_the_block(march, tmp_path_factory):
    """A document of exactly ``chunk_bytes`` UTF-8 bytes with no safe point
    fills a block of that size to its last byte; its last characters are
    written by the block stores, which reach past the bytes they write.
    Whatever the storage (1-byte, Cyrillic, CJK, mixed, emoji) and whatever
    ASCII comes first, the block holds the document's UTF-8 and not one
    guard byte after it is touched."""
    lib = build_for(march, tmp_path_factory)
    for wide in ("é", "ж", "中", "ж中a中", "😀"):
        for head in range(48):
            doc = "a" * head + wide * (96 // len(wide))
            data = doc.encode("utf-8")
            n, block, guard, written = pack_exact_block(lib, [doc], len(data))
            assert (n, written) == (1, len(data)), (wide, head)
            assert block.tobytes() == data, (wide, head)
            assert (guard == 0xA5).all(), (wide, head)
