"""The traffic generator: deterministic per seed, other documents for
another seed, the same set of lengths, whole documents in batches of at
most the batch size, no document twice in the ring."""

import json
import os

import numpy as np
import pytest

from tokbench import harness, ring

# (config, traffic) of the cells, and of the multilingual mix kept as data
# for a later cell
CELLS = [("cl100k-books", "encode"), ("r50k-web", "encode"),
         ("cl100k-books", "multilingual-encode")]


def _ring(root, cell, seed):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    config, traffic = cell
    c = harness.cell_from({"name": f"{config}-{traffic}", "config": config,
                           "traffic": traffic, "chips": 1}, bench, root)
    return c, ring.build_ring(c.config, c.traffic, seed, os.path.join(root, "tokbench"))


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_ring_other_seed_other_documents(tiny_root, cell):
    _c, a = _ring(tiny_root, cell, 2**31 + 7)
    _c, b = _ring(tiny_root, cell, 2**31 + 7)
    _c, c = _ring(tiny_root, cell, 5)
    assert a.batches == b.batches
    docs_a = {d for batch in a.batches for d in batch}
    docs_c = {d for batch in c.batches for d in batch}
    assert not docs_a & docs_c
    # the same set of sizes and scripts, in another order
    # the same batches by size and script, in another order
    make_up = lambda r: [(tuple(sorted(s.tolist())), tuple(sorted(x)))
                         for s, x in zip(r.doc_bytes, r.scripts)]
    assert make_up(a) != make_up(c)
    sizes = lambda r: sorted(make_up(r))
    assert [x for _s, x in sizes(a)] == [x for _s, x in sizes(c)]
    for (sa, _x), (sc, _y) in zip(sizes(a), sizes(c)):
        assert np.allclose(sa, sc, atol=3)


@pytest.mark.parametrize("cell", CELLS)
def test_batches_hold_whole_documents_up_to_the_batch_size(tiny_root, cell):
    c, r = _ring(tiny_root, cell, 99)
    limit = c.traffic["batch_bytes"]
    total = 0
    for batch, nbytes, sizes in zip(r.batches, r.batch_bytes, r.doc_bytes):
        assert [len(d.encode("utf-8")) for d in batch] == sizes.tolist()
        assert nbytes == sum(sizes)
        assert nbytes <= limit or len(batch) == 1
        total += nbytes
    assert len(r) >= c.traffic["ring_min_batches"]
    assert total >= c.traffic["ring_min_bytes"]
    docs = [d for batch in r.batches for d in batch]
    assert len(set(docs)) == len(docs)


def test_full_size_plan_reaches_the_ring_size(bench):
    """The document plan of every cell at its real size: at least 64 batches'
    and 256 MiB's worth of bytes, lengths inside the configured clip."""
    for w in bench["workloads"]:
        c = harness.load_cell(w["name"])
        lengths, scripts = ring.document_plan(c.config["documents"], c.traffic)
        d = c.config["documents"]
        assert lengths.sum() >= c.traffic["ring_min_bytes"]
        assert lengths.sum() >= c.traffic["ring_min_batches"] * c.traffic["batch_bytes"]
        assert lengths.min() >= d["min_bytes"] and lengths.max() <= d["max_bytes"]
        assert set(scripts) == set(c.traffic["scripts"])


def test_text_follows_its_script():
    spec = ring.load_text_spec("english")
    pool = ring.phrase_pool(spec, ring.rng_for(1, 2), wrap_rate=0.07)
    text = b"".join(pool[:2000]).decode("ascii")
    words = set(spec["words"])
    assert sum(w.strip(".,;!?'\n").lower() in words for w in text.split()) > 0.6 * len(text.split())
    assert "\n" in text
    cjk = ring.phrase_pool(ring.load_text_spec("cjk"), ring.rng_for(1, 3))
    sample = b"".join(cjk[:100]).decode("utf-8")
    assert set(sample) <= set(ring.load_text_spec("cjk")["chars"]) | {"。", "\n"}


def test_batch_plan_fills_greedily_with_whole_documents():
    lengths = np.array([3, 4, 2, 9, 10, 1, 1, 5])
    groups = ring.batch_plan(lengths, 10)
    assert [g.tolist() for g in groups] == [[0, 1, 2], [3], [4], [5, 6, 7]]
    for g, nxt in zip(groups[:-1], groups[1:]):
        assert lengths[g].sum() <= 10 < lengths[g].sum() + lengths[nxt[0]]


def test_documents_start_at_phrases_and_never_repeat():
    pool = [bytes([97 + i, 97 + j]) + b" " for i in range(5) for j in range(5)]
    texts, sizes = ring.documents(pool, np.array([2] * 20 + [7] * 5),
                                  np.random.default_rng(1), set())
    assert len(set(texts)) == len(texts) == 25
    assert sizes.tolist() == [2] * 20 + [7] * 5
    assert all(t[:2].encode() + b" " in pool for t in texts)
    with pytest.raises(ValueError):
        ring.documents(pool[:2], np.array([2] * 5), np.random.default_rng(1), set())
