"""The port's one merge (``pipeline.merge_bucket_v3``) on the buckets that
the JAX package gives its wide-bucket hybrid, against that hybrid and the
host oracle, exactly.

Token for token against the oracle's sequential merge: the cases of
``tests/test_merge_exact.py``, in the cold loop form and again with the round
count the cold form reported. Piece for piece against the JAX package's
``merge_bucket_exact`` (its batched round and compacting phases). End to end:
a default engine over the documents that the JAX engine routes to its wide
merge, cold and warmed passes, against that JAX engine.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jtokkit_tpu.engine import presplit
from jtokkit_tpu.engine.oracle import byte_pair_merge
from jtokkit_tpu.ops import merge_exact as jax_exact
from jtokkit_tpu.vocab.definitions import BUILTIN_DEFINITIONS
from jtokkit_tpu_torch.ops import merge, pipeline

from .conftest import load_conformance_rows
from .test_merge_exact import CASES
from .test_torch_engine import engines

# The suite runs in several worker processes at once; torch's own thread
# pool in each of them would oversubscribe the cores.
torch.set_num_threads(1)

CJK = "的一是不了人我在有他这为之大来以个中上们到说国和地也子时道出而要于就下得可你年生自会那后能对着事其里所去行过家十用发天如然作方成者多日都三小军二无同么经法当起与好看学进种将还分此心"


def _t(x):
    return torch.from_numpy(np.array(x))


def _bucket_inputs(pieces):
    """One bucket holding ``pieces``, as ``tests/test_merge_exact.py`` lays
    it out: (cap, buf, starts, lens, miss_sorted) as numpy arrays."""
    cap = max(128, 1 << (len(pieces) - 1).bit_length())
    buf = np.frombuffer(b"".join(pieces), dtype=np.uint8).copy()
    lens = np.zeros(cap, np.int32)
    lens[: len(pieces)] = [len(p) for p in pieces]
    starts = np.zeros(cap, np.int32)
    starts[1 : len(pieces)] = np.cumsum(lens[: len(pieces)])[:-1]
    return cap, buf, starts, lens, np.arange(cap, dtype=np.int32)


def run_bucket(enc_name, pieces, lanes, rounds=None):
    """Merge ``pieces`` (all <= lanes bytes) as one Stage B bucket through
    the port's ``merge_bucket_v3``. Returns (tokens per piece, rounds)."""
    port = engines(enc_name)[2]
    t = port.tables
    cap, buf, starts, lens, miss_sorted = _bucket_inputs(pieces)
    cols, ids, active, ran = pipeline.merge_bucket_v3(
        _t(buf), _t(starts), _t(lens), _t(miss_sorted), torch.tensor(0, dtype=torch.int32),
        len(pieces), t.byte_to_id, t.byte_pair_id, t.pair_rows_cat, t.table_mask,
        lanes=lanes, cap=cap, rounds=rounds,
    )
    assert not active[:, len(pieces):].any(), "a dead column is active"
    cols, ids, active = cols.numpy(), ids.numpy(), active.numpy()
    results = [[] for _ in pieces]
    for r in range(len(pieces)):
        results[cols[r]] = ids[active[:, r], r].tolist()
    return results, ran


def check(enc_name, pieces, lanes):
    """Cold form, then the fixed-count form with the cold form's count:
    both equal the oracle's sequential merge, and read nothing the second
    time (the round counter advances by exactly the cached count)."""
    ranks = engines(enc_name)[0].ranks
    want = [byte_pair_merge(p, ranks) for p in pieces]
    got, ran = run_bucket(enc_name, pieces, lanes)
    for p, g, w in zip(pieces, got, want):
        assert g == w, f"{p!r}: {g[:12]} != {w[:12]}"
    before, tests = merge.MERGE_ROUNDS, merge.EXIT_TESTS
    again, ran2 = run_bucket(enc_name, pieces, lanes, rounds=ran)
    assert again == want and ran2 == ran
    assert merge.MERGE_ROUNDS - before == ran and merge.EXIT_TESTS == tests


def _conformance_pieces(enc_name):
    d = BUILTIN_DEFINITIONS[enc_name]
    ranks = engines(enc_name)[0].ranks
    pieces = set()
    for text, _, _ in load_conformance_rows(enc_name):
        for a, b in presplit.split(text, d.pattern):
            pb = text[a:b].encode("utf-8")
            if ranks.get(pb) is None and len(pb) >= 2:
                pieces.add(pb)
    return sorted(pieces)


def _cjk_pieces(seed=7, n=40):
    rng = random.Random(seed)
    return [
        "".join(rng.choice(CJK) for _ in range(rng.randint(30, 180))).encode("utf-8")
        for _ in range(n)
    ]


@pytest.mark.parametrize("lanes", [32, 512, 4096])
@pytest.mark.parametrize("enc_name", ["cl100k_base", "r50k_base"])
def test_merge_exact_cases(enc_name, lanes):
    """Short pieces in buckets up to the widest: the merge does not depend on
    the rows past a piece's end."""
    check(enc_name, [p for p in CASES if len(p) <= lanes], lanes)


@pytest.mark.parametrize("enc_name", ["cl100k_base", "p50k_base"])
def test_merge_exact_conformance_pieces(enc_name):
    """All merge-needing pieces of the golden corpus, bucketed as the engine
    would bucket them."""
    pieces = _conformance_pieces(enc_name)
    checked = 0
    for lanes in (8, 16, 32, 64, 128):
        lo = 0 if lanes == 8 else lanes // 2
        batch = [p for p in pieces if lo < len(p) <= lanes]
        if batch:
            check(enc_name, batch, lanes)
            checked += len(batch)
    assert checked > 0


def test_merge_exact_cjk_long():
    pieces = _cjk_pieces()
    check("cl100k_base", pieces, 1 << (max(len(p) for p in pieces) - 1).bit_length())


def test_merge_exact_fuzz_bytes():
    rng = random.Random(3)
    pieces = [
        bytes(rng.randrange(256) for _ in range(rng.randint(2, 64)))
        for _ in range(120)
    ]
    check("cl100k_base", pieces, 64)


@pytest.mark.parametrize("enc_name", ["cl100k_base", "r50k_base"])
def test_merge_exact_repeat_runs(enc_name):
    """Equal-rank chains: repeated bytes and whitespace of many lengths."""
    pieces = [
        ch * n
        for ch in (b" ", b"-", b"a", b"\t", b"=", b"\n", b"\xe4")
        for n in (2, 3, 5, 8, 13, 31, 64, 120)
    ]
    check(enc_name, pieces, 128)


# ---- piece for piece against the JAX package's hybrid ----------------


@pytest.mark.parametrize("enc_name,lanes", [("cl100k_base", 128), ("p50k_base", 64)])
def test_merge_bucket_exact_matches_jax(enc_name, lanes):
    """Every piece's tokens equal those of the JAX hybrid, which emits each
    piece in exactly one of its phases."""
    _orc, jax_eng, _port = engines(enc_name)
    pieces = [p for p in _cjk_pieces(13, 60) + list(CASES) if len(p) <= lanes]
    cap, buf, starts, lens, miss_sorted = _bucket_inputs(pieces)
    cols_j, outs_j = jax_exact.merge_bucket_exact(
        jnp.asarray(buf), jnp.asarray(starts), jnp.asarray(lens),
        jnp.asarray(miss_sorted), jnp.int32(0), jnp.int32(len(pieces)),
        jax_eng._byte_to_id, jax_eng._byte_pair_seed, jax_eng._pair_rows_cat,
        jax_eng.packed.table_mask, lanes=lanes, cap=cap,
    )
    cols_j = np.asarray(cols_j)
    want = [None] * len(pieces)
    for ids_j, act_j in outs_j:
        ids_j, act_j = np.asarray(ids_j), np.asarray(act_j)
        for r in np.flatnonzero(act_j[:, : len(pieces)].any(axis=0)):
            assert want[cols_j[r]] is None, f"piece {cols_j[r]} emitted twice"
            want[cols_j[r]] = ids_j[act_j[:, r], r].tolist()
    assert len(outs_j) > 1 and None not in want
    got, ran = run_bucket(enc_name, pieces, lanes)
    assert got == want and ran > 0


# ---- the engine over the documents the JAX engine routes wide -------------

WIDE_DOCS = [
    "今日はよい天気です" "東京都港区" * 12,          # long CJK letter run
    "." * 200 + "!" * 90,                          # punctuation runs
    "mixed 短い run with spaces and 漢字" * 6,
    "plain english words stay on the narrow engine.",
]


def test_engine_wide_routing_parity(monkeypatch):
    """A default engine (every bucket on the one merge) over documents with
    buckets of 64 lanes and more reproduces the oracle over cold and warmed
    count and encode passes, and the JAX engine with its wide merge on; its
    mapped count groups those chunks by shape like any other."""
    orc, _jax, port = engines("cl100k_base")
    docs = WIDE_DOCS + [" ".join(_p.decode() for _p in _cjk_pieces(21, 8))]
    want = [orc.encode_ordinary(t)[0] for t in docs]
    assert port.encode_ordinary_batch(docs) == want
    assert port.count_tokens_batch(docs) == [len(w) for w in want]

    plan = port.preload_corpus(docs)
    total = sum(len(w) for w in want)
    assert port.count_tokens_corpus(docs, plan=plan) == total
    assert any(lanes >= 64 for c in plan.chunk_cache for _b, lanes, _c, _n in c["caps"])
    assert all(isinstance(r, int) for c in plan.chunk_cache for r in c["rounds"])
    reads = port.host_reads
    for _ in range(2):
        assert port.count_tokens_corpus(None, plan=plan) == total
    assert sum(b.n_live for b in plan.mapped_count) == len(plan)
    assert port.host_reads - reads == 2
    for k in range(3):
        got = port.encode_ordinary_batch_arrays(None, plan=plan)
        assert [g.tolist() for g in got] == want, f"pass {k}"
    assert port.host_reads - reads == 2 + 2 + 1 + 1

    monkeypatch.setenv("JTOKKIT_TPU_WIDE_MIN", "64")
    from jtokkit_tpu.engine.device import DeviceEngine as JaxEngine

    jax_wide = JaxEngine.from_oracle(orc)
    assert jax_wide._wide_min_lanes == 64
    # the JAX engine compiles every (lanes, capacity) it meets, so it gets
    # the documents its own wide-routing test uses
    jax_plan = jax_wide.preload_corpus(WIDE_DOCS)
    plan = port.preload_corpus(WIDE_DOCS)
    total = sum(len(w) for w in want[: len(WIDE_DOCS)])
    assert jax_wide.count_tokens_corpus(WIDE_DOCS, plan=jax_plan) == total
    assert port.count_tokens_corpus(WIDE_DOCS, plan=plan) == total
    got = jax_wide.encode_ordinary_batch_arrays(None, plan=jax_plan)
    assert [g.tolist() for g in got] == want[: len(WIDE_DOCS)]
    got = port.encode_ordinary_batch_arrays(None, plan=plan)
    assert [g.tolist() for g in got] == want[: len(WIDE_DOCS)]
    assert [c["caps"] for c in plan.chunk_cache] == [
        [tuple(int(x) for x in cap) for cap in c["caps"]] for c in jax_plan.chunk_cache
    ]
