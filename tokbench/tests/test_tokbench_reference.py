"""The reference reproduces the conformance files of all four encodings;
its heap merge makes the same merges as tiktoken's scan; its decode table
inverts its encode."""

import ast
import csv
import os
import random

import numpy as np
import pytest

from tokbench.reference import Reference, merge

from .conftest import REPO

ENCODINGS = {
    "r50k_base": ("r50k_base", "gpt2"),
    "p50k_base": ("p50k_base", "gpt2"),
    "p50k_edit": ("p50k_base", "gpt2"),
    "cl100k_base": ("cl100k_base", "cl100k"),
}
_CACHE = {}


def reference(vocab, pattern):
    if (vocab, pattern) not in _CACHE:
        path = os.path.join(REPO, "jtokkit_tpu", "vocab", "assets", f"{vocab}.tiktoken")
        _CACHE[vocab, pattern] = Reference(path, pattern)
    return _CACHE[vocab, pattern]


@pytest.mark.parametrize("name", sorted(ENCODINGS))
def test_reproduces_the_conformance_file(name):
    ref = reference(*ENCODINGS[name])
    path = os.path.join(REPO, "tests", "data", f"{name}_encodings.csv")
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f, skipinitialspace=True))
    assert len(rows) > 400
    for r in rows:
        want = ast.literal_eval(r["output"])
        got = ref.encode(r["input"])
        assert got == want, r["input"]
        assert ref.decode(np.array(got, np.int64)) == r["input"].encode("utf-8")


def scan_merge(piece, ranks):
    """tiktoken's byte_pair_merge: the lowest rank by a scan, the leftmost
    of equal ranks, neighbours' ranks recomputed before the removal."""
    big = 1 << 62
    parts = [[i, big] for i in range(len(piece) + 1)]

    def rank(i, skip):
        if i + skip + 2 >= len(parts):
            return big
        return ranks.get(piece[parts[i][0]:parts[i + skip + 2][0]], big)

    for i in range(len(parts) - 2):
        parts[i][1] = rank(i, 0)
    while len(parts) > 1:
        low, at = big, 0
        for i in range(len(parts) - 1):
            if parts[i][1] < low:
                low, at = parts[i][1], i
        if low == big:
            break
        parts[at][1] = rank(at, 1)
        if at > 0:
            parts[at - 1][1] = rank(at - 1, 1)
        del parts[at + 1]
    return [ranks[piece[parts[i][0]:parts[i + 1][0]]] for i in range(len(parts) - 1)]


@pytest.mark.parametrize("vocab", ["cl100k_base", "r50k_base"])
def test_heap_merge_equals_the_scan(vocab):
    ranks = reference(vocab, "cl100k").ranks
    rng = random.Random(7)
    alphabet = ["a", "b", "e", "t", "h", "的", "一", "🙂", " ", "'", "1", "é"]
    for _ in range(400):
        piece = "".join(rng.choice(alphabet) for _ in range(rng.randint(2, 40))).encode()
        assert merge(piece, ranks) == scan_merge(piece, ranks)
    for n in (1, 2, 3, 200):
        piece = ("的" * n).encode()
        assert merge(piece, ranks) == scan_merge(piece, ranks)


def test_merge_limit_stops_early():
    ranks = reference("cl100k_base", "cl100k").ranks
    piece = " remarkable".encode()
    assert len(merge(piece, ranks, limit=0)) == len(piece)
    assert merge(piece, ranks, limit=None) == scan_merge(piece, ranks)


def test_decode_rejects_an_id_that_is_no_token():
    ref = reference("cl100k_base", "cl100k")
    with pytest.raises(IndexError):
        ref.decode(np.array([9906, 1 << 20]))
    with pytest.raises(IndexError):
        ref.decode(np.array([-1]))
