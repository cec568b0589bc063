"""The warmed encode's per-chunk body, against the staged dispatch and the
JAX engine's cached dispatch, and the CPU side of the encode graphs.

On CUDA the warmed encode records ``DeviceEngine._chunk_body`` as one CUDA
graph per ok-chunk and replays it (``tests/test_torch_encode_graphs_card.py``
holds the replays against the eager dispatch on the card). On the CPU the
same body runs eagerly and no graph is made. Both engines run with 128 KiB
chunks (``chunk_bytes=1<<17`` for the port, ``tests/conftest.py`` for the JAX
engine) and keep long pieces on the device merge (``native_long=False``; the
JAX engine with ``JTOKKIT_TPU_NATIVE_LONG=0``). Inputs are made from seeded
numpy; every comparison is exact (tolerance 0).
"""

import numpy as np
import pytest
import torch

from jtokkit_tpu.engine.device import DeviceEngine as JaxEngine
from jtokkit_tpu.utils import corpus
from jtokkit_tpu_torch.engine.device import DeviceEngine
from jtokkit_tpu_torch.ops import scan

from .test_torch_engine import engines
from .test_torch_native import _spanning_doc
from .test_torch_steady import common_words

# The suite runs in several worker processes at once; torch's own thread
# pool in each of them would oversubscribe the cores.
torch.set_num_threads(1)

NAMES = ["cl100k_base", "r50k_base"]
_JAX = {}


def jax_device_merge(name, monkeypatch):
    """The JAX engine that keeps every chunk on its device merge: routing is
    decided at its first long-piece chunk, which finds the switch off."""
    monkeypatch.setenv("JTOKKIT_TPU_NATIVE_LONG", "0")
    if name not in _JAX:
        _JAX[name] = JaxEngine.from_oracle(engines(name)[0])
    return _JAX[name]


def flavor_docs(flavor: str):
    """A small seeded corpus of each flavor: english in two chunks, mixed
    (emoji and short CJK runs) and cjk (letter runs of 120-600 bytes, which
    the routing would send to the native engine) cut to a few KB."""
    if flavor == "english":
        return corpus.generate(0.2, seed=11, flavor="english")
    if flavor == "mixed":
        return [d[:40_000] for d in corpus.generate(0.1, seed=12, flavor="mixed")]
    return [d[:2_000] for d in corpus.generate(0.01, seed=13, flavor="cjk")] + ["tail"]


@pytest.mark.parametrize("flavor", ["english", "mixed", "cjk"])
@pytest.mark.parametrize("name", NAMES)
def test_encode_body_matches_staged_and_jax(name, flavor, monkeypatch):
    """Chunk by chunk: the body run eagerly over a warmed plan, the staged
    (cold) dispatch and the JAX engine's ``_process_chunks_cached`` give the
    same ids, and the body's fetch reads back to them."""
    orc, _jax, port = engines(name)
    body_against_staged_and_jax(orc, port, jax_device_merge(name, monkeypatch),
                                flavor_docs(flavor))


def body_against_staged_and_jax(orc, port, jax_eng, docs):
    """The body of every ok-chunk of a warmed plan of ``docs`` on ``port``
    against the staged dispatch and ``jax_eng``'s cached dispatch, exactly.
    Returns the plan."""
    plan = port.preload_corpus(docs)
    staged = port._process_chunks(None, want_tokens=True, plan=plan)
    assert [r[0] for r in staged] == [c["kind"] for c in plan.chunk_cache]
    assert all(r[0] == "ok" for r in staged), "every chunk stays on the device merge"
    want = [r[2][: int(r[3])].numpy() for r in staged]
    arrays = port.encode_ordinary_batch_arrays(None, plan=plan)  # caches the counts
    assert [a.tolist() for a in arrays] == [orc.encode_ordinary(t)[0] for t in docs]
    assert plan.n_tokens == [len(w) for w in want]

    body = []
    for oki, (entry, c) in enumerate(zip(plan, plan.chunk_cache)):
        tokens, n_tokens, doc_counts, packed = port._chunk_body(
            plan, oki, c, entry[4], entry[5], True)
        assert doc_counts is None and int(n_tokens) == plan.n_tokens[oki]
        got = port._consume_fetch(port._copy_fetch(plan.pinned, oki, packed), plan.n_tokens[oki])
        np.testing.assert_array_equal(tokens[: plan.n_tokens[oki]].numpy(), got)
        body.append(got)

    jax_plan = jax_eng.preload_corpus(docs)
    jax_eng.encode_ordinary_batch_arrays(docs, plan=jax_plan)
    jax_res = [r for r in jax_eng._process_chunks_cached(jax_plan, True) if r[0] == "ok"]
    assert [c["kind"] for c in jax_plan.chunk_cache] == [c["kind"] for c in plan.chunk_cache]
    assert jax_plan.n_tokens == plan.n_tokens
    jax_ids = [jax_eng._consume_fetch(r[5], n) for r, n in zip(jax_res, jax_plan.n_tokens)]
    assert len(body) == len(want) == len(jax_ids) >= 1
    for k, (b, w, j) in enumerate(zip(body, want, jax_ids)):
        np.testing.assert_array_equal(b, w, err_msg=f"chunk {k}: body against staged")
        np.testing.assert_array_equal(b, j, err_msg=f"chunk {k}: body against JAX")
    return plan


@pytest.mark.parametrize("name", NAMES)
def test_cpu_plan_has_no_graphs(name):
    """Four passes over a CPU plan (the cold one caches the counts, three
    warmed): identical arrays, one host read and one eager Stage A run a
    chunk in each warmed pass, no graph and no replay."""
    orc, _jax, port = engines(name)
    docs = [common_words(21, 20_000), "Zyzzyva „curly” 98765 😀 " * 900, "", None,
            common_words(22, 300)]
    expect = [orc.encode_ordinary(t)[0] if t else [] for t in docs]
    plan = port.preload_corpus(docs)
    replays, launches = port.graph_replays, scan.KERNEL_LAUNCHES
    first = port.encode_ordinary_batch_arrays(docs, plan=plan)
    assert [a.tolist() for a in first] == expect
    for k in range(3):
        reads, runs = port.host_reads, port.stage_a_runs
        arrays = port.encode_ordinary_batch_arrays(None, plan=plan)
        assert all(np.array_equal(a, b) for a, b in zip(arrays, first)), f"pass {k + 2}"
        assert all(a.dtype == np.int32 for a in arrays)
        assert port.host_reads - reads == 1, f"pass {k + 2}"
        assert port.stage_a_runs - runs == len(plan)
    assert plan.encode_graphs is None and plan.encode_pool_bytes == 0
    assert port.graph_replays == replays and scan.KERNEL_LAUNCHES == launches
    assert not port._replays_encode(plan), "a CPU plan replays nothing"


def _route_engine(kind):
    """(engine, documents) with one chunk that leaves the device path as
    ``kind``: a piece over 4096 bytes on the ``native_long=False`` engine,
    or a chunk of long CJK pieces on an engine that routes them."""
    port = engines("cl100k_base")[2]
    if kind == "fallback":
        return port, [common_words(2, 40_000), "b" * 5000 + " tail", common_words(3, 100)]
    routed = DeviceEngine.from_oracle(port.oracle, device="cpu", chunk_bytes=1 << 17)
    return routed, ["first doc", _spanning_doc(), "last 中文 doc"]


@pytest.mark.parametrize("kind", ["fallback", "native"])
def test_host_chunks_keep_their_paths(kind):
    """A chunk routed to the long-piece fallback or to the native engine
    keeps its host path in every warmed encode pass; the ok-chunks around it
    run the body, and the ids equal the oracle's."""
    eng, docs = _route_engine(kind)
    orc = engines("cl100k_base")[0]
    expect = [orc.encode_ordinary(t)[0] if t else [] for t in docs]
    plan = eng.preload_corpus(docs)
    counter = "fallback_chunks" if kind == "fallback" else "native_chunks"
    for k in range(4):
        before = getattr(eng, counter)
        arrays = eng.encode_ordinary_batch_arrays(docs if k == 0 else None, plan=plan)
        assert [a.tolist() for a in arrays] == expect, f"pass {k}"
        assert getattr(eng, counter) == before + 1, f"pass {k}"
    kinds = [c["kind"] for c in plan.chunk_cache]
    assert kinds.count(kind) == 1 and kinds.count("ok") == len(plan) - 1
    assert len(plan.n_tokens) == len(plan) - 1
    assert plan.encode_graphs is None


# ---- the buckets the JAX package routes to its wide-bucket merge (64 lanes
# and more): the port's default engine runs them through the one merge, the
# same body, graphs on the card, none here

WIDE_MIN = 64


def wide_engines(monkeypatch):
    """(port engine, JAX engine): the port's default engine with long pieces
    on the device merge, and the JAX engine with its wide merge on from
    ``WIDE_MIN`` lanes (read from ``JTOKKIT_TPU_WIDE_MIN`` when it is
    built)."""
    monkeypatch.setenv("JTOKKIT_TPU_NATIVE_LONG", "0")
    monkeypatch.setenv("JTOKKIT_TPU_WIDE_MIN", str(WIDE_MIN))
    if "wide" not in _JAX:
        _JAX["wide"] = JaxEngine.from_oracle(engines("cl100k_base")[0])
    assert _JAX["wide"]._wide_min_lanes == WIDE_MIN
    return engines("cl100k_base")[2], _JAX["wide"]


def wide_buckets(plan):
    """The round counts of the buckets of ``WIDE_MIN`` lanes and more over
    the plan's chunks."""
    return [r for c in plan.chunk_cache if c["kind"] == "ok"
            for (_b, lanes, _cap, _n), r in zip(c["caps"], c["rounds"])
            if lanes >= WIDE_MIN]


@pytest.mark.parametrize("flavor", ["mixed", "cjk"])
def test_wide_body_matches_staged_and_jax(flavor, monkeypatch):
    """Over documents with wide buckets, the body (every bucket's merge at
    its cached rounds), chunk by chunk, against its staged dispatch and the
    JAX engine's cached dispatch with its wide merge on."""
    port, jax_eng = wide_engines(monkeypatch)
    plan = body_against_staged_and_jax(engines("cl100k_base")[0], port, jax_eng,
                                       flavor_docs(flavor))
    rounds = wide_buckets(plan)
    assert rounds and all(isinstance(r, int) for r in rounds)


def test_wide_count_equals_encode_total(monkeypatch):
    """Over a warmed plan of cjk and english chunks the count groups the
    chunks with wide buckets by shape like any other, reads once a pass,
    and equals the encode's total pass after pass."""
    port, _jax = wide_engines(monkeypatch)
    orc = engines("cl100k_base")[0]
    docs = flavor_docs("cjk") + flavor_docs("english")
    want = [orc.encode_ordinary(t)[0] for t in docs]
    total = sum(len(w) for w in want)
    plan = port.preload_corpus(docs)
    assert port.count_tokens_corpus(docs, plan=plan) == total  # cold
    for k in range(3):
        reads = port.host_reads
        assert port.count_tokens_corpus(None, plan=plan) == total, f"pass {k}"
        assert port.host_reads - reads == 1
        arrays = port.encode_ordinary_batch_arrays(None, plan=plan)
        assert [a.tolist() for a in arrays] == want, f"pass {k}"
    assert all(c["kind"] == "ok" for c in plan.chunk_cache) and len(plan) >= 2
    assert wide_buckets(plan)
    by_shape = {(c["variant"], c["divs"], len(e[0]), e[1].shape[0])
                for e, c in zip(plan, plan.chunk_cache)}
    assert len(plan.mapped_count) >= len(by_shape)
    assert sum(b.n_live for b in plan.mapped_count) == len(plan)


def test_wide_cpu_plan_has_no_graphs(monkeypatch):
    """A plan with wide buckets on the CPU counts and encodes eagerly: no
    graph is made or replayed, and the scan wrapper is never asked for its
    kernel."""
    port, _jax = wide_engines(monkeypatch)
    orc = engines("cl100k_base")[0]
    docs = flavor_docs("cjk")
    want = [orc.encode_ordinary(t)[0] for t in docs]
    plan = port.preload_corpus(docs)
    replays, launches = port.graph_replays, scan.KERNEL_LAUNCHES
    for k in range(3):
        assert [a.tolist() for a in port.encode_ordinary_batch_arrays(
            docs if k == 0 else None, plan=plan)] == want
        assert port.count_tokens_corpus(None, plan=plan) == sum(len(w) for w in want)
    assert wide_buckets(plan)
    assert plan.encode_graphs is None and plan.encode_pool_bytes == 0
    assert all(b.graph is None for b in plan.mapped_count) and plan.graph_pool_bytes == 0
    assert port.graph_replays == replays and scan.KERNEL_LAUNCHES == launches
    assert not port._replays_encode(plan)
