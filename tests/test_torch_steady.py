"""The port's steady state over a warmed CorpusPlan, against the JAX engine
and the host oracle.

Both engines run on the CPU with 128 KiB chunks (``chunk_bytes=1<<17`` for
the port, ``tests/conftest.py`` for the JAX engine), so the same texts make
the same chunks in both. Inputs are fixed or made from seeded numpy; every
comparison is exact.
"""

import numpy as np
import pytest
import torch

from jtokkit_tpu.engine.device import CorpusPlan as JaxCorpusPlan
from jtokkit_tpu.utils import corpus
from jtokkit_tpu_torch.engine.device import CorpusPlan
from jtokkit_tpu_torch.ops import merge, scan

from .test_torch_engine import engines

# The suite runs in several worker processes at once; torch's own thread
# pool in each of them would oversubscribe the cores.
torch.set_num_threads(1)

_COMMON = (
    "the and of to in is it that for with as on be at by this from or an are "
    "not you all can has have was but we they one new time out up if so no "
    "more will any"
).split()


def common_words(seed: int, n_words: int) -> str:
    """Text of frequent english words: nearly every cl100k id is below 4094."""
    rng = np.random.default_rng(seed)
    return " ".join(_COMMON[i] for i in rng.integers(0, len(_COMMON), n_words))


STEADY_TEXTS = [
    "Steady state pass %d: the quick brown fox jumps. " % i * (1 + i % 4)
    for i in range(12)
] + ["日本語テキスト " * 6, "", "punct!!! ??? \n\n  mixed 12345"]


def _lists(arrays):
    return [a.tolist() for a in arrays]


def test_plan_cache_steady_state():
    """A warmed CorpusPlan reproduces the first pass exactly, and a plain
    list passed as ``plan`` still works (and is never warmed)."""
    orc, _jax, port = engines("cl100k_base")
    expect = [orc.encode_ordinary(t)[0] for t in STEADY_TEXTS]

    plan = port.preload_corpus(STEADY_TEXTS)
    assert isinstance(plan, CorpusPlan) and plan.chunk_cache is None
    total1 = port.count_tokens_corpus(STEADY_TEXTS, plan=plan)
    assert plan.chunk_cache is not None, "first pass must warm the plan"
    assert port.count_tokens_corpus(STEADY_TEXTS, plan=plan) == total1
    assert plan.mapped_count, "second count pass takes the mapped count"
    assert total1 == sum(len(e) for e in expect)

    # first encode pass fills n_tokens/doc_counts; the second reuses them
    got1 = port.encode_ordinary_batch_arrays(None, plan=plan)
    assert plan.n_tokens is not None and plan.doc_counts is not None
    got2 = port.encode_ordinary_batch_arrays(None, plan=plan)
    assert _lists(got1) == expect
    assert _lists(got2) == expect
    assert all(a.dtype == np.int32 for a in got2)

    plain = list(port.preload_corpus(STEADY_TEXTS))
    for _ in range(2):
        assert _lists(port.encode_ordinary_batch_arrays(None, plan=plain)) == expect
        assert port.count_tokens_corpus(None, plan=plain) == total1
    assert not hasattr(plain, "chunk_cache")


def _corpus_docs(overflow: bool = True):
    """About 500 KB in five chunks: english, a CJK and emoji mix and, with
    ``overflow``, a run of single-byte pieces that overflows the primary
    piece table (the port retries such a chunk with the roomy capacities;
    the JAX engine sends it to its host fallback)."""
    docs = corpus.generate(0.33, seed=5, flavor="english")
    docs += corpus.generate(0.1, seed=6, flavor="mixed")
    if overflow:
        docs.append("a1" * 20_000)
    docs.append(None)
    return docs


def test_count_tokens_corpus_matches_jax_and_oracle():
    """Cold, warmed and warmed again: the JAX engine's total and the
    oracle's, with one host read per warmed pass."""
    orc, jax_eng, port = engines("cl100k_base")
    docs = _corpus_docs()
    want = sum(len(orc.encode_ordinary(t)[0]) for t in docs)
    jax_plan = jax_eng.preload_corpus(docs)
    assert isinstance(jax_plan, JaxCorpusPlan)
    jax_totals = [jax_eng.count_tokens_corpus(docs, plan=jax_plan) for _ in range(2)]

    plan = port.preload_corpus(docs)
    assert len(plan) == len(jax_plan) >= 3
    runs = port.stage_a_runs
    cold = port.count_tokens_corpus(docs, plan=plan)
    cold_runs = port.stage_a_runs - runs
    assert cold_runs == len(plan) + 1, "the a1 chunk retries with roomy capacities"
    reads = port.host_reads
    warm1 = port.count_tokens_corpus(None, plan=plan)
    assert port.host_reads - reads == 1
    warm2 = port.count_tokens_corpus(None, plan=plan)
    assert port.host_reads - reads == 2
    assert [cold, warm1, warm2] == [want] * 3 == jax_totals + [want]

    # the blocks: chunks grouped by shape, remainders padded to a power of
    # two with all-zero chunks; no graph on a CPU device
    blocks = plan.mapped_count
    assert sum(b.n_live for b in blocks) == len(plan)
    assert all(len(b.bufs) in (1, 2, 4, 8) and b.graph is None for b in blocks)
    assert any(len(b.bufs) > b.n_live for b in blocks), "no padded block"
    assert port.stage_a_runs - runs == cold_runs + 2 * sum(len(b.bufs) for b in blocks)
    # a group's signature holds every chunk's capacity and round count
    for c in plan.chunk_cache:
        for (b, lanes, cap, _cnt), r in zip(c["caps"], c["rounds"]):
            assert any(
                (b, lanes) == s[:2] and s[2] >= cap and s[3] >= r
                for blk in blocks if (blk.variant, blk.divs) == (c["variant"], c["divs"])
                for s in blk.sig
            )


def test_warmed_plan_matches_jax():
    """The warmed plan's cached values equal the JAX engine's, chunk for
    chunk: routing, capacities, token and document counts."""
    _orc, jax_eng, port = engines("cl100k_base")
    docs = _corpus_docs(overflow=False)
    jax_plan = jax_eng.preload_corpus(docs)
    want = jax_eng.encode_ordinary_batch_arrays(docs, plan=jax_plan)
    plan = port.preload_corpus(docs)
    got = port.encode_ordinary_batch_arrays(docs, plan=plan)
    assert _lists(got) == _lists(want)
    assert len(plan.chunk_cache) == len(jax_plan.chunk_cache)
    for c, cj in zip(plan.chunk_cache, jax_plan.chunk_cache):
        assert {k: c[k] for k in ("kind", "variant", "divs")} == {
            k: cj[k] for k in ("kind", "variant", "divs")}
        assert c["caps"] == [tuple(int(x) for x in cap) for cap in cj["caps"]]
        assert len(c["rounds"]) == len(c["caps"])
    assert plan.n_tokens == jax_plan.n_tokens
    assert len(plan.doc_counts) == len(jax_plan.doc_counts)
    for d, dj in zip(plan.doc_counts, jax_plan.doc_counts):
        np.testing.assert_array_equal(d, dj)
    for _ in range(2):
        assert _lists(port.encode_ordinary_batch_arrays(None, plan=plan)) == _lists(want)


def test_host_reads_cold_and_warmed():
    """``host_reads``: a cold pass pays the meta fetch, the merge loops' exit
    tests and its result fetches; a warmed pass pays one read, and none
    before its fetch."""
    orc, _jax, port = engines("cl100k_base")
    docs = [common_words(1, 30_000), "Zyzzyva quixotic 😀 „curly” 98765 " * 300]
    expect = [orc.encode_ordinary(t)[0] for t in docs]
    plan = port.preload_corpus(docs)

    reads, rounds, tests = port.host_reads, merge.MERGE_ROUNDS, merge.EXIT_TESTS
    assert _lists(port.encode_ordinary_batch_arrays(None, plan=plan)) == expect
    ran = [r for c in plan.chunk_cache for r in c["rounds"]]
    assert merge.MERGE_ROUNDS - rounds == sum(ran) > 0
    # Stage A metas, one exit test per round and a last one per bucket, the
    # small-meta fetch, the wait on the token copies
    assert merge.EXIT_TESTS - tests == sum(ran) + len(ran)
    assert port.host_reads - reads == 1 + (sum(ran) + len(ran)) + 1 + 1

    reads, rounds, tests = port.host_reads, merge.MERGE_ROUNDS, merge.EXIT_TESTS
    results = port._process_chunks_cached(plan, want_tokens=True)
    assert port.host_reads == reads, "the cached dispatch reads nothing back"
    assert merge.EXIT_TESTS == tests, "a fixed-count loop tested for its exit"
    assert merge.MERGE_ROUNDS - rounds == sum(ran)
    assert all(len(r) == 6 and r[4] is None for r in results)
    assert _lists(port.encode_ordinary_batch_arrays(None, plan=plan)) == expect
    assert port.host_reads - reads == 1

    reads = port.host_reads
    total = port.count_tokens_corpus(None, plan=plan)
    assert total == sum(len(e) for e in expect)
    assert port.host_reads - reads == 1


def test_fallback_chunk_keeps_its_path_in_a_warmed_plan():
    """A chunk with a piece over 4096 bytes stays on the long-piece fallback
    in cold and warmed passes, beside chunks that take the mapped count."""
    orc, _jax, port = engines("cl100k_base")
    docs = [common_words(2, 40_000), "b" * 5000 + " tail", common_words(3, 100)]
    expect = [orc.encode_ordinary(t)[0] for t in docs]
    plan = port.preload_corpus(docs)
    chunks = port.fallback_chunks
    for k in range(3):
        assert port.count_tokens_corpus(None, plan=plan) == sum(map(len, expect))
        assert port.fallback_chunks == chunks + k + 1
    assert [c["kind"] for c in plan.chunk_cache].count("fallback") == 1
    assert sum(b.n_live for b in plan.mapped_count) == len(plan) - 1
    for _ in range(3):
        assert _lists(port.encode_ordinary_batch_arrays(None, plan=plan)) == expect
    assert len(plan.n_tokens) == len(plan) - 1


@pytest.mark.parametrize("extra", [0, 3])
def test_merge_rows_t3_fixed_rounds(extra):
    """``rounds=k`` runs exactly k rounds and equals the cold loop for k =
    its own count and for more (a round with nothing to merge is a no-op)."""
    _orc, _jax, port = engines("cl100k_base")
    rng = np.random.default_rng(23)
    W, R = 32, 200
    text = corpus.generate(0.01, seed=4, flavor="mixed")[0].encode()
    starts = rng.integers(0, len(text) - W, R)
    mat = torch.from_numpy(
        np.stack([np.frombuffer(text[s : s + W], np.uint8) for s in starts], 1).copy()
    )
    lens = torch.from_numpy(rng.integers(0, W + 1, R).astype(np.int32))
    t = port.tables
    args = (mat, lens, t.byte_to_id, t.byte_pair_id, t.pair_rows_cat, t.table_mask)
    before = merge.MERGE_ROUNDS
    ids_c, act_c, ran = merge.merge_rows_t3(*args)
    assert merge.MERGE_ROUNDS - before == ran > 0
    before = merge.MERGE_ROUNDS
    ids_k, act_k, ran_k = merge.merge_rows_t3(
        *args, rounds=ran + extra
    )
    assert merge.MERGE_ROUNDS - before == ran_k == ran + extra
    assert torch.equal(act_k, act_c)
    assert torch.equal(torch.where(act_k, ids_k, -1), torch.where(act_c, ids_c, -1))
    if not extra and ran > 1:
        _ids, act_few, _ran = merge.merge_rows_t3(*args, rounds=ran - 1)
        assert not torch.equal(act_few, act_c), "the last round merged nothing"


def test_scan_count_replay_keeps_the_clear_on_schedule():
    """A replay of a graph that holds recorded scans advances the scratch's
    calls and ``REPLAYED_SCANS``, never ``KERNEL_LAUNCHES`` (nothing is
    launched by the wrapper), and clears the status words before the epoch
    could come round."""
    key = (0, 987654321)  # device index 0, a stream handle no stream has
    words = torch.arange(16, dtype=torch.int64)
    entry = scan.SCRATCH[key] = scan._Scratch(words.clone())
    try:
        dev = torch.device("cuda", 0)
        launches, replayed = scan.KERNEL_LAUNCHES, scan.REPLAYED_SCANS
        scan.count_replay(dev, key[1], 40)
        assert (entry.calls, scan.REPLAYED_SCANS - replayed) == (40, 40)
        assert torch.equal(entry.words, words)
        entry.calls = scan.CLEAR_EVERY - 39
        scan.count_replay(dev, key[1], 40)
        assert (entry.calls, scan.REPLAYED_SCANS - replayed) == (40, 80)
        assert scan.KERNEL_LAUNCHES == launches
        assert torch.equal(entry.words[: scan.HEADER_WORDS], words[: scan.HEADER_WORDS])
        assert not entry.words[scan.HEADER_WORDS :].any()
    finally:
        del scan.SCRATCH[key]
        scan.REPLAYED_SCANS = replayed
