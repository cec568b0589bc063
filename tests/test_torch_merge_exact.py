"""The port's wide-bucket hybrid merge (ops/merge_exact, ops/colscan) against
the JAX package's functions and the host oracle, exactly.

Array for array on seeded inputs: ``col_scan`` / ``excl_fwd`` / ``excl_rev``,
``rank_from_state``, ``round1_bytes``, ``_compact`` and ``merge_bucket_exact``
(ids where active, phase by phase). Token for token against the oracle's
sequential merge: the cases of ``tests/test_merge_exact.py``, in the cold
loop form and again with the round counts the cold form reported. End to
end: an engine with ``wide_min_lanes=64`` over cold and warmed passes.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jtokkit_tpu.engine import presplit
from jtokkit_tpu.engine.oracle import byte_pair_merge
from jtokkit_tpu.ops import colscan as jax_colscan
from jtokkit_tpu.ops import merge as jax_merge
from jtokkit_tpu.ops import merge_exact as jax_exact
from jtokkit_tpu.vocab.definitions import BUILTIN_DEFINITIONS
from jtokkit_tpu_torch.engine.device import DeviceEngine
from jtokkit_tpu_torch.ops import colscan, merge, merge_exact

from .conftest import load_conformance_rows
from .test_merge_exact import CASES
from .test_torch_engine import engines

# The suite runs in several worker processes at once; torch's own thread
# pool in each of them would oversubscribe the cores.
torch.set_num_threads(1)

CJK = "的一是不了人我在有他这为之大来以个中上们到说国和地也子时道出而要于就下得可你年生自会那后能对着事其里所去行过家十用发天如然作方成者多日都三小军二无同么经法当起与好看学进种将还分此心"


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=msg)


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
    """Merge ``pieces`` (all <= lanes bytes) through the port's
    merge_bucket_exact. Returns (tokens per piece, rounds per phase)."""
    port = engines(enc_name)[2]
    t = port.tables
    cap, buf, starts, lens, miss_sorted = _bucket_inputs(pieces)
    cols, outs, ran = merge_exact.merge_bucket_exact(
        _t(buf), _t(starts), _t(lens), _t(miss_sorted), torch.tensor(0, dtype=torch.int32),
        len(pieces), t.byte_to_id, t.byte_pair_seed, t.pair_rows_cat, t.table_mask,
        lanes=lanes, cap=cap, rounds=rounds,
    )
    assert len(outs) == len(ran) == len(merge_exact.phase_chain(lanes))
    cols = cols.numpy()
    results = [[] for _ in pieces]
    seen = np.zeros(len(pieces), dtype=bool)
    for ids_k, act_k in outs:
        ids_k, act_k = ids_k.numpy(), act_k.numpy()
        assert not act_k[:, len(pieces):].any(), "a dead column emitted"
        for r in np.flatnonzero(act_k.any(axis=0)):
            p = cols[r]
            assert not seen[p], f"piece {p} emitted twice"
            seen[p] = True
            results[p] = ids_k[act_k[:, r], r].tolist()
    return results, ran


def check(enc_name, pieces, lanes):
    """Cold form, then the fixed-count form with the cold form's counts:
    both equal the oracle's sequential merge, and read nothing the second
    time (the round counter advances by exactly the cached counts)."""
    ranks = engines(enc_name)[0].ranks
    want = [byte_pair_merge(p, ranks) for p in pieces]
    got, ran = run_bucket(enc_name, pieces, lanes)
    for p, g, w in zip(pieces, got, want):
        assert g == w, f"{p!r}: {g[:12]} != {w[:12]}"
    before = merge.MERGE_ROUNDS
    again, ran2 = run_bucket(enc_name, pieces, lanes, rounds=ran)
    assert again == want and ran2 == ran
    assert merge.MERGE_ROUNDS - before == sum(ran)


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


@pytest.mark.parametrize("enc_name", ["cl100k_base", "r50k_base"])
def test_merge_exact_cases(enc_name):
    check(enc_name, [p for p in CASES if len(p) <= 32], 32)


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


def test_fewer_rounds_than_the_cold_pass_lose_spans():
    """Why cached round counts are used as they are: a phase cut short
    leaves columns wider than the next width, and compaction drops spans."""
    pieces = _cjk_pieces(seed=9, n=20)
    lanes = 1 << (max(len(p) for p in pieces) - 1).bit_length()
    want, ran = run_bucket("cl100k_base", pieces, lanes)
    assert ran[0] > 0
    short, _ = run_bucket("cl100k_base", pieces, lanes, rounds=(0,) + ran[1:])
    assert short != want


# ---- array for array against the JAX functions ---------------------------


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("kind", ["last", "max", "add"])
def test_col_scan_matches_jax(kind, reverse):
    rng = np.random.default_rng(5)
    W, R = 96, 67
    if kind == "add":
        x = rng.integers(0, 3, (W, R)).astype(np.int32)
    else:
        x = np.where(rng.random((W, R)) < 0.2, rng.integers(0, 1000, (W, R)), -1).astype(np.int32)
    x[:, 0] = -1 if kind != "add" else 0  # a column with nothing set
    (want,) = jax_colscan.col_scan([jnp.asarray(x)], [kind], reverse=reverse)
    (got,) = colscan.col_scan([_t(x)], [kind], reverse=reverse)
    assert got.dtype == torch.int32
    _eq(got, want)
    excl_j = jax_colscan.excl_rev if reverse else jax_colscan.excl_fwd
    excl_t = colscan.excl_rev if reverse else colscan.excl_fwd
    (want,) = excl_j([jnp.asarray(x)], [kind])
    (got,) = excl_t([_t(x)], [kind])
    _eq(got, want)


def _byte_matrix(enc_name, seed, W=64):
    """A bucket matrix of CJK, repeated-byte and random-byte pieces."""
    rng = random.Random(seed)
    pieces = _cjk_pieces(seed, 30) + [CASES[k] for k in (2, 3, 4, 5, 16, 17)]
    pieces += [bytes(rng.randrange(256) for _ in range(rng.randint(2, W))) for _ in range(40)]
    pieces = [p[:W] for p in pieces]
    R = 128
    mat = np.zeros((W, R), np.uint8)
    lens = np.zeros(R, np.int32)
    for r, p in enumerate(pieces):
        mat[: len(p), r] = np.frombuffer(p, np.uint8)
        lens[r] = len(p)
    return mat, lens


@pytest.mark.parametrize("enc_name", ["cl100k_base", "r50k_base"])
def test_round1_rank_and_compact_match_jax(enc_name):
    """round1_bytes, then rank_from_state on its state, then _compact."""
    _orc, jax_eng, port = engines(enc_name)
    t = port.tables
    mat, lens = _byte_matrix(enc_name, 11)
    want = jax_exact.round1_bytes(
        jnp.asarray(mat), jnp.asarray(lens), jax_eng._byte_to_id, jax_eng._byte_pair_seed
    )
    got = merge_exact.round1_bytes(_t(mat), _t(lens), t.byte_to_id, t.byte_pair_seed)
    ids, active, progress, counts = got
    _eq(active, want[1], "active")
    _eq(torch.where(active, ids, -1), jnp.where(want[1], want[0], -1), "ids")
    assert bool(progress) == bool(want[2]) is True
    _eq(counts, want[3], "counts")
    assert int(counts.max()) < mat.shape[0], "round 1 merged nothing"

    rank_j = jax_merge.rank_from_state(
        want[0], want[1], jax_eng._pair_rows_cat, jax_eng.packed.table_mask
    )
    rank = merge.rank_from_state(ids, active, t.pair_rows_cat, t.table_mask)
    _eq(rank, rank_j, "rank")
    assert int((rank < merge.MAX_RANK).sum()) > 0

    w_new = 1 << int(counts.max() - 1).bit_length()
    c_j = jax_exact._compact(want[0], rank_j, want[1], w_new)
    c_t = merge_exact._compact(ids, rank, active, w_new)
    _eq(c_t[2], c_j[2], "compact active")
    _eq(torch.where(c_t[2], c_t[0], -1), jnp.where(c_j[2], c_j[0], -1), "compact ids")
    _eq(c_t[1], c_j[1], "compact rank")
    _eq(c_t[2].sum(0), counts, "compaction dropped a span")


@pytest.mark.parametrize("enc_name,lanes", [("cl100k_base", 128), ("p50k_base", 64)])
def test_merge_bucket_exact_matches_jax(enc_name, lanes):
    """Every phase's output: the same columns active, the same ids there."""
    _orc, jax_eng, port = engines(enc_name)
    t = port.tables
    pieces = [p for p in _cjk_pieces(13, 60) + list(CASES) if len(p) <= lanes]
    cap, buf, starts, lens, miss_sorted = _bucket_inputs(pieces)
    cols_j, outs_j = jax_exact.merge_bucket_exact(
        jnp.asarray(buf), jnp.asarray(starts), jnp.asarray(lens),
        jnp.asarray(miss_sorted), jnp.int32(0), jnp.int32(len(pieces)),
        jax_eng._byte_to_id, jax_eng._byte_pair_seed, jax_eng._pair_rows_cat,
        jax_eng.packed.table_mask, lanes=lanes, cap=cap,
    )
    cols, outs, ran = merge_exact.merge_bucket_exact(
        _t(buf), _t(starts), _t(lens), _t(miss_sorted), 0, len(pieces),
        t.byte_to_id, t.byte_pair_seed, t.pair_rows_cat, t.table_mask,
        lanes=lanes, cap=cap,
    )
    _eq(cols, cols_j)
    assert len(outs) == len(outs_j) == len(ran)
    emitted = 0
    for k, ((ids, act), (ids_j, act_j)) in enumerate(zip(outs, outs_j)):
        _eq(act, act_j, f"phase {k} active")
        _eq(torch.where(act, ids, -1), jnp.where(act_j, ids_j, -1), f"phase {k} ids")
        emitted += int(act.any(dim=0).sum())
    assert emitted == len(pieces)


# ---- the engine with wide routing -----------------------------------------

WIDE_DOCS = [
    "今日はよい天気です" "東京都港区" * 12,          # long CJK letter run
    "." * 200 + "!" * 90,                          # punctuation runs
    "mixed 短い run with spaces and 漢字" * 6,
    "plain english words stay on the narrow engine.",
]


def test_engine_wide_routing_parity(monkeypatch):
    """An engine with ``wide_min_lanes=64`` reproduces the oracle, the narrow
    port engine and the JAX engine with its wide merge on, over cold and
    warmed count and encode passes; in the mapped count each chunk with a
    wide bucket is a block of its own at its own per-phase rounds."""
    orc, _jax, narrow = engines("cl100k_base")
    wide = DeviceEngine.from_oracle(
        narrow.oracle, device="cpu", chunk_bytes=1 << 17, wide_min_lanes=64,
        native_long=False,
    )
    assert narrow.wide_min_lanes == 1 << 30 and wide.wide_min_lanes == 64
    docs = WIDE_DOCS + [" ".join(_p.decode() for _p in _cjk_pieces(21, 8))]
    want = [orc.encode_ordinary(t)[0] for t in docs]
    assert wide.encode_ordinary_batch(docs) == want
    assert narrow.encode_ordinary_batch(WIDE_DOCS) == want[: len(WIDE_DOCS)]
    assert wide.count_tokens_batch(docs) == [len(w) for w in want]

    plan = wide.preload_corpus(docs)
    total = sum(len(w) for w in want)
    assert wide.count_tokens_corpus(docs, plan=plan) == total
    wide_rounds = [
        r for c in plan.chunk_cache
        for (_b, lanes, _cap, _cnt), r in zip(c["caps"], c["rounds"]) if lanes >= 64
    ]
    assert wide_rounds and all(isinstance(r, tuple) for r in wide_rounds)
    reads = wide.host_reads
    for _ in range(2):
        assert wide.count_tokens_corpus(None, plan=plan) == total
    blocks = plan.mapped_count
    assert [(b.n_live, len(b.bufs)) for b in blocks] == [(1, 1)] * len(plan)
    assert [b.sig for b in blocks] == [
        tuple((b, lanes, cap, r) for (b, lanes, cap, _n), r in zip(c["caps"], c["rounds"]))
        for c in plan.chunk_cache
    ]
    assert wide.host_reads - reads == 2
    for k in range(3):
        got = wide.encode_ordinary_batch_arrays(None, plan=plan)
        assert [g.tolist() for g in got] == want, f"pass {k}"
    assert wide.host_reads - reads == 2 + 2 + 1 + 1

    monkeypatch.setenv("JTOKKIT_TPU_WIDE_MIN", "64")
    from jtokkit_tpu.engine.device import DeviceEngine as JaxEngine

    jax_wide = JaxEngine.from_oracle(orc)
    assert jax_wide._wide_min_lanes == 64
    # the JAX engine compiles every (lanes, capacity) it meets, so it gets
    # the documents its own wide-routing test uses
    jax_plan = jax_wide.preload_corpus(WIDE_DOCS)
    plan = wide.preload_corpus(WIDE_DOCS)
    total = sum(len(w) for w in want[: len(WIDE_DOCS)])
    assert jax_wide.count_tokens_corpus(WIDE_DOCS, plan=jax_plan) == total
    assert wide.count_tokens_corpus(WIDE_DOCS, plan=plan) == total
    got = jax_wide.encode_ordinary_batch_arrays(None, plan=jax_plan)
    assert [g.tolist() for g in got] == want[: len(WIDE_DOCS)]
    got = wide.encode_ordinary_batch_arrays(None, plan=plan)
    assert [g.tolist() for g in got] == want[: len(WIDE_DOCS)]
    assert [c["caps"] for c in plan.chunk_cache] == [
        [tuple(int(x) for x in cap) for cap in c["caps"]] for c in jax_plan.chunk_cache
    ]
