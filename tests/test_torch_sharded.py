"""The port's data-parallel path over torch.distributed on the CPU (gloo),
against the JAX package's sharding rule and the host oracle, exactly.

Counterparts of ``tests/test_sharded.py`` (a world-1 group in this process)
and ``tests/test_multihost.py`` (two ranks in child processes).
"""

import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from jtokkit_tpu.engine.device import DeviceEngine as JaxEngine
from jtokkit_tpu.engine.oracle import OracleEngine as JaxOracle
from jtokkit_tpu.parallel.mesh import data_mesh
from jtokkit_tpu.parallel.sharded import ShardedTokenizer as JaxSharded
from jtokkit_tpu.vocab.definitions import BUILTIN_DEFINITIONS
from jtokkit_tpu.vocab.loader import load_builtin_ranks
from jtokkit_tpu_torch import entry
from jtokkit_tpu_torch.engine.device import DeviceEngine
from jtokkit_tpu_torch.engine.oracle import OracleEngine
from jtokkit_tpu_torch.parallel import mesh
from jtokkit_tpu_torch.parallel.sharded import ShardedTokenizer
from jtokkit_tpu_torch.utils import corpus
from jtokkit_tpu_torch.vocab import loader as port_loader

from .test_torch_native import _spanning_doc

torch.set_num_threads(1)

_STATE = {}

TEXTS = [
    "Hello, world! This is shard content.",
    "日本語のテキスト、そして emoji 🙂🙂",
    "",
    "short",
    "  whitespace   runs\n\nand newlines\r\n",
    "I'm counting 1234567 tokens' worth of text.",
    "Ω≈ç√∫˜µ≤≥÷ — punctuation galore!!!",
    "yet another document " * 40,
    "中文" * 120,
]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """A world-1 gloo group in this process for the module's tests."""
    store = tmp_path_factory.mktemp("store") / "rendezvous"
    dev = mesh.initialize_distributed(f"file://{store}", 1, 0, device="cpu")
    assert dev == torch.device("cpu")
    yield mesh.data_group()
    dist.destroy_process_group()


def sharded(chunk_bytes=1 << 17):
    """(JAX oracle, a sharded tokenizer over a CPU engine)."""
    if not _STATE:
        d = BUILTIN_DEFINITIONS["cl100k_base"]
        _STATE["orc"] = JaxOracle(
            d.name, d.pattern, load_builtin_ranks(d.vocab_name), d.special_tokens
        )
        _STATE["port_orc"] = OracleEngine(
            d.name, d.pattern, port_loader.load_builtin_ranks(d.vocab_name),
            d.special_tokens,
        )
    if chunk_bytes not in _STATE:
        _STATE[chunk_bytes] = ShardedTokenizer(DeviceEngine.from_oracle(
            _STATE["port_orc"], device="cpu", chunk_bytes=chunk_bytes
        ))
    return _STATE["orc"], _STATE[chunk_bytes]


@pytest.mark.parametrize("n_dev", [1, 2, 3, 8])
def test_shard_docs_matches_jax(n_dev):
    """The greedy byte-balanced assignment is the reference's, rank by rank
    (the JAX method reads only ``n_dev``, so a stand-in object carries it)."""
    texts = TEXTS + ["x" * k for k in (7, 700, 70, 7000)] + [None, "日本" * 33]
    want = JaxSharded._shard_docs(types.SimpleNamespace(n_dev=n_dev), texts)[2]
    port = ShardedTokenizer.__new__(ShardedTokenizer)
    port.n_dev = n_dev
    assert port._shard_docs(texts) == want


def test_initialize_distributed_does_nothing_without_arguments():
    assert mesh.initialize_distributed() is None
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        mesh.data_group()


def test_initialize_distributed_follows_the_named_device(monkeypatch):
    """The backend follows the device: NCCL for a CUDA device (which raises
    here, with no card), gloo for the CPU; no card is probed for it."""
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append(backend))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.initialize_distributed("tcp://localhost:1", 1, 0)
    assert mesh.initialize_distributed("tcp://localhost:1", 1, 0, device="cpu") == (
        torch.device("cpu"))
    assert calls == ["gloo"]


def test_sharded_encode_matches_oracle(group):
    orc, tok = sharded()
    assert (tok.n_dev, tok.rank) == (1, 0)
    got = tok.encode_ordinary_batch(TEXTS)
    for t, g in zip(TEXTS, got):
        assert g == orc.encode_ordinary(t)[0], repr(t)


def test_sharded_count_matches_encode(group):
    orc, tok = sharded()
    expect = sum(len(orc.encode_ordinary(t)[0]) for t in TEXTS)
    reduces = tok.collectives["all_reduce"]
    assert tok.count_tokens_corpus(TEXTS) == expect
    assert tok.collectives["all_reduce"] == reduces + 1


def test_sharded_empty(group):
    _orc, tok = sharded()
    assert tok.encode_ordinary_batch([]) == []
    assert tok.count_tokens_corpus([]) == 0
    assert tok.encode_ordinary_batch(["", ""]) == [[], []]


@pytest.mark.parametrize("routed", [True, False], ids=["native", "device"])
def test_sharded_plan_reuse(group, routed):
    """A preloaded plan: later passes run warmed (the count as the mapped
    count) and stay exact. With the CJK document the one chunk goes to the
    native engine, without it the chunk stays on the device."""
    orc, tok = sharded()
    texts = TEXTS if routed else TEXTS[:-1]
    plan = tok.preload_corpus(texts)
    expect = [orc.encode_ordinary(t)[0] for t in texts]
    total = sum(len(e) for e in expect)
    for _ in range(3):
        assert tok.count_tokens_corpus(None, plan=plan) == total
    assert [c["kind"] for c in plan.plan.chunk_cache] == ["native" if routed else "ok"]
    assert len(plan.plan.mapped_count) == (0 if routed else 1)
    for _ in range(2):
        got = tok.encode_ordinary_batch_arrays(None, plan=plan)
        assert [g.tolist() for g in got] == expect
    assert (plan.plan.n_tokens is None) == routed


def test_sharded_long_piece_degrades_only_its_chunk(group):
    """A document with a piece over 4096 bytes takes the engine's per-chunk
    fallback on its rank; the other documents (in a chunk of their own at
    4 KiB chunks) stay on the staged path."""
    orc, tok = sharded(chunk_bytes=1 << 12)
    texts = TEXTS[:-1] + ["a" * 5000]
    plan = tok.preload_corpus(texts)
    before = tok.engine.fallback_chunks
    expect = [orc.encode_ordinary(t)[0] for t in texts]
    got = tok.encode_ordinary_batch_arrays(None, plan=plan)
    assert [g.tolist() for g in got] == expect
    assert tok.count_tokens_corpus(None, plan=plan) == sum(len(e) for e in expect)
    assert [c["kind"] for c in plan.plan.chunk_cache] == ["ok", "fallback"]
    assert tok.engine.fallback_chunks == before + 2


def routed_docs():
    """A seeded english corpus beside a document with a 5000-byte piece (its
    128 KiB chunk takes the long-piece fallback), two empty documents, and a
    document whose english lines fill a device chunk and whose CJK lines
    fill the last chunk, which routes to the native engine."""
    return (corpus.generate(0.05, seed=41, flavor="english")
            + ["b" * 5000 + " tail", "", None, _spanning_doc()])


def jax_sharded_arrays(docs):
    """The JAX ``ShardedTokenizer``'s arrays on the virtual 8-device CPU mesh
    (computed once per corpus: its first compile takes tens of seconds)."""
    key = ("jax", tuple(d or "" for d in docs))
    if key not in _STATE:
        orc = sharded()[0]
        tok = JaxSharded(JaxEngine.from_oracle(orc), data_mesh())
        _STATE[key] = [a.tolist() for a in tok.encode_ordinary_batch_arrays(docs)]
    return _STATE[key]


@pytest.mark.parametrize("case", ["routed", "device", "empty"])
def test_warmed_sharded_encode_matches_single_oracle_and_jax(group, case):
    """Three passes over one plan (the first gathers the layout, the next
    two keep the rank's tokens on the device and gather them once) equal
    the single engine's arrays, the oracle's and the JAX ShardedTokenizer's
    on the virtual CPU mesh. ``routed`` holds an ok, a fallback and a native
    chunk; ``device`` its english part only; ``empty`` no document, so the
    one rank sends nothing."""
    orc, tok = sharded()
    docs = {"routed": routed_docs(), "device": routed_docs()[:1], "empty": []}[case]
    want = [orc.encode_ordinary(t)[0] if t else [] for t in docs]
    assert jax_sharded_arrays(docs) == want
    single = tok.engine.encode_ordinary_batch_arrays(docs)
    assert [a.tolist() for a in single] == want
    plan = tok.preload_corpus(docs)
    for k in range(3):
        got = tok.encode_ordinary_batch_arrays(None, plan=plan)
        assert len(got) == len(docs) and all(g.dtype == np.int32 for g in got)
        assert [g.tolist() for g in got] == want, f"pass {k}"
    kinds = [c["kind"] for c in plan.plan.chunk_cache or []]
    assert kinds == {"routed": ["fallback", "ok", "native"], "device": ["ok"],
                     "empty": []}[case]


def test_warmed_sharded_pass_gathers_once(group, monkeypatch):
    """The layout is gathered once per plan, at its first encode; every
    later pass makes ONE all_gather, no other collective and one host read,
    and fetches no device chunk's tokens through the engine's token fetch
    (no ``_copy_fetch``, no ``_consume_fetch``)."""
    orc, tok = sharded()
    eng = tok.engine
    docs = routed_docs()[:1] + ["short one", "", "yet another document " * 30]
    want = [orc.encode_ordinary(t)[0] if t else [] for t in docs]
    plan = tok.preload_corpus(docs)
    before = dict(tok.collectives)
    assert [g.tolist() for g in tok.encode_ordinary_batch_arrays(None, plan=plan)] == want
    assert {k: tok.collectives[k] - before[k] for k in before} == {
        "all_reduce": 0, "all_gather": 2}
    layout, recv = plan.layout, plan.recv
    assert [t for t, _c in layout] == [sum(len(w) for w in want)]
    assert layout[0][1].tolist() == [len(w) for w in want]

    calls = []
    for name in ("_copy_fetch", "_consume_fetch"):
        monkeypatch.setattr(eng, name, lambda *a, _n=name: calls.append(_n))
    for k in range(3):
        before, reads = dict(tok.collectives), eng.host_reads
        got = tok.encode_ordinary_batch_arrays(None, plan=plan)
        assert [g.tolist() for g in got] == want, f"pass {k}"
        assert {k: tok.collectives[k] - before[k] for k in before} == {
            "all_reduce": 0, "all_gather": 1}
        assert eng.host_reads - reads == 1
    assert calls == [] and plan.layout is layout and plan.recv is recv


def test_plan_tokens_need_a_first_encode(group):
    """``encode_plan_tokens`` over a plan that was only counted raises; after
    the pass that caches the token counts it gives the arrays joined."""
    orc, tok = sharded()
    eng = tok.engine
    docs = TEXTS[:-1]
    plan = eng.preload_corpus(docs)
    eng.count_tokens_corpus(docs, plan=plan)
    with pytest.raises(ValueError, match="first encode"):
        eng.encode_plan_tokens(plan)
    arrays = eng.encode_ordinary_batch_arrays(None, plan=plan)
    joined = eng.encode_plan_tokens(plan)
    assert joined.dtype == torch.int32 and joined.device == eng.device
    assert joined.tolist() == [t for d in docs for t in orc.encode_ordinary(d)[0]]
    assert joined.tolist() == np.concatenate(arrays).tolist()


def test_two_gloo_ranks_in_child_processes():
    """Two ranks, one child process each: both check the all_reduced count,
    the all_gathered encode and three passes of a warmed encode (one over a
    plan whose one document leaves rank 1 empty) against the host oracle;
    the children are killed if they outlast 300 s."""
    outs = entry.dryrun_multichip(2, timeout=300, device="cpu")
    for rank, out in enumerate(outs):
        assert f"rank {rank}: all_reduce count ok" in out, out[-3000:]
        assert f"rank {rank}: 0 scan kernel launches" in out, out[-3000:]
        assert f"rank {rank}: all_gather encode ok" in out, out[-3000:]
        n = 2 * 3 + 2
        assert (f"rank {rank}: warmed encode of {n} documents ok (all_gathers 2 1 1; "
                f"empty ranks [])") in out, out[-3000:]
        assert (f"rank {rank}: warmed encode of 1 documents ok (all_gathers 2 1 1; "
                f"empty ranks [1])") in out, out[-3000:]
    # the CJK document is routed to the native engine on exactly one rank
    assert sum("0 native chunks" not in out for out in outs) == 1


@pytest.mark.parametrize("cards", [None, 1])
def test_dryrun_defaults_to_the_cards(monkeypatch, cards):
    """Without ``device`` the dry run wants one NCCL rank per CUDA card: it
    raises before it starts a child when there is no card, or fewer cards
    than ranks."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards is not None)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards or 0)
    match = "none is available" if cards is None else "2 ranks need 2 CUDA cards"
    with pytest.raises(RuntimeError, match=match):
        entry.dryrun_multichip(2)
