"""The un-planned path's graph cache on the card: replays against the eager
path chunk by chunk, the reads of a call whose shapes are cached, and a
capture that fails. Token ids are int32: tolerance 0.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_cold_cache_card.py

Without a CUDA card its tests skip.
"""

import pytest
import torch

from jtokkit_tpu_torch import Encodings, EncodingType
from jtokkit_tpu_torch.engine.device import DeviceEngine
from jtokkit_tpu_torch.ops import merge, scan
from jtokkit_tpu_torch.utils import corpus

_STATE = {}


def _engines():
    """(oracle, engine with the graph cache, the same engine without it),
    both on the card and on the device merge for every chunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs an H100")
    if not _STATE:
        enc = Encodings.new_default_encoding_registry().get_encoding(
            EncodingType.CL100K_BASE)
        _STATE["orc"] = enc.oracle
        _STATE["cached"] = DeviceEngine.from_oracle(enc.oracle, native_long=False)
        _STATE["eager"] = DeviceEngine.from_oracle(
            enc.oracle, native_long=False, cold_cache=False)
    return _STATE["orc"], _STATE["cached"], _STATE["eager"]


def _docs(seed):
    return (corpus.generate(2, seed=seed, flavor="english")
            + corpus.generate(0.5, seed=seed, flavor="mixed"))


@pytest.mark.gpu
def test_replays_equal_the_eager_path_chunk_by_chunk():
    """Every ok-chunk of an un-planned encode: tokens, token count and
    per-document counts from the cache's replays equal the eager path's;
    the rounds read from the device counters equal the eager loops'."""
    _orc, cached, eager = _engines()
    assert cached.cold_cache and not eager.cold_cache
    docs = _docs(11)
    got = cached._process_chunks(docs, want_tokens=True)
    want = eager._process_chunks(docs, want_tokens=True)
    assert [r[0] for r in got] == [r[0] for r in want]
    assert len(got.pending) == sum(r[0] == "ok" for r in got) and not want.pending
    ns = cached._read(torch.stack([r[3] for r in got if r[0] == "ok"]), got.pending)
    assert got.pending == []
    for k, (g, w) in enumerate(zip(got, want)):
        if g[0] != "ok":
            continue
        n = int(w[3])
        assert int(g[3]) == n == ns[sum(r[0] == "ok" for r in got[:k])]
        assert torch.equal(g[2][:n], w[2][:n]), k
        assert torch.equal(g[4], w[4]), k
    plan_c, plan_e = cached.preload_corpus(docs), eager.preload_corpus(docs)
    assert cached.count_tokens_corpus(None, plan=plan_c) == \
        eager.count_tokens_corpus(None, plan=plan_e)
    assert [c.get("rounds") for c in plan_c.chunk_cache] == \
        [c.get("rounds") for c in plan_e.chunk_cache]


@pytest.mark.gpu
def test_second_call_replays_with_three_reads():
    """A second un-planned encode over a fresh seed of the same shapes: at
    most 3 host reads plus one per capacity-retry batch (2 for the count),
    no exit test read back, no eager Stage A run, no scan launch by the
    wrapper, no capture; ids equal the oracle's."""
    orc, cached, _eager = _engines()
    cached.encode_ordinary_batch(_docs(12))
    cached.count_tokens_batch(_docs(12))
    docs = _docs(13)
    for fn, limit in ((cached.encode_ordinary_batch, 3), (cached.count_tokens_batch, 2)):
        before = (cached.host_reads, merge.EXIT_TESTS, cached.stage_a_runs,
                  scan.KERNEL_LAUNCHES, cached.cold_captures, cached.capacity_retries)
        out = fn(docs)
        reads, tests, runs, launches, captures, retries = (
            a - b for a, b in zip((cached.host_reads, merge.EXIT_TESTS, cached.stage_a_runs,
                                   scan.KERNEL_LAUNCHES, cached.cold_captures,
                                   cached.capacity_retries), before))
        assert reads <= limit + retries and (tests, runs, launches, captures) == (0, 0, 0, 0)
        if limit == 3:
            tokens = out
    assert out == [len(t) for t in tokens]
    for d, t in zip(docs[:8], tokens[:8]):
        assert t == orc.encode_ordinary(d)[0]


@pytest.mark.gpu
def test_a_failed_capture_raises():
    """A unit whose recording reads the card back cannot be captured: the
    call raises, nothing falls back."""
    orc, _cached, _eager = _engines()
    eng = DeviceEngine.from_oracle(orc, native_long=False)
    real = eng._stage_a

    def syncing(*args):
        table, meta = real(*args)
        if torch.cuda.is_current_stream_capturing():
            int(meta[0])  # a host read inside the capture
        return table, meta

    eng._stage_a = syncing
    with pytest.raises(RuntimeError):
        eng.encode_ordinary_batch(["a capture that fails " * 50])


@pytest.mark.gpu
def test_streamed_call_issues_without_a_synchronise():
    """An un-planned 4 MiB call after a warm-up call of the same shapes (so
    that no capture falls inside): from its first plan step to its last
    Stage A issue nothing synchronises the card (torch's sync debug mode
    raises at a synchronising call), so no upload waits for the Stage A
    issued before it. Its answers equal the eager path's."""
    _orc, cached, eager = _engines()
    docs = corpus.generate(4, seed=14, flavor="english")
    want = [a.tolist() for a in eager.encode_ordinary_batch_arrays(docs)]
    cached.encode_ordinary_batch_arrays(docs)
    real_stream, real_read = cached._stream_stage_a, cached._read_metas

    def guarded(texts):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real_stream(texts)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    def read(staged):
        # the metas read after the last issue is the call's first wait
        torch.cuda.set_sync_debug_mode("default")
        return real_read(staged)

    cached._stream_stage_a, cached._read_metas = guarded, read
    try:
        streamed, captures = cached.streamed_chunks, cached.cold_captures
        got = [a.tolist() for a in cached.encode_ordinary_batch_arrays(docs)]
        n = sum(1 for _ in cached._plan_chunks(docs))
    finally:
        del cached._stream_stage_a, cached._read_metas
    assert n >= 4 and cached.streamed_chunks - streamed == n - 1
    assert cached.cold_captures == captures
    assert got == want
