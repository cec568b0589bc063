"""The warmed encode as CUDA graph replays, on the card: replayed passes
against the eager cached dispatch, exactly (int32 ids, tolerance 0).

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_encode_graphs_card.py

Without a CUDA card its test skips.
"""

import numpy as np
import pytest
import torch

from jtokkit_tpu_torch import Encodings, EncodingType
from jtokkit_tpu_torch.engine.device import DeviceEngine
from jtokkit_tpu_torch.ops import merge, scan
from jtokkit_tpu_torch.utils import corpus


def _eager_ids(engine, plan):
    """Every ok-chunk's ids from the eager cached dispatch."""
    res = [r for r in engine._dispatch_eager(plan, True) if r[0] == "ok"]
    engine._wait_fetches()
    return [engine._consume_fetch(r[5], n) for r, n in zip(res, plan.n_tokens)]


@pytest.mark.gpu
def test_encode_replays_equal_the_eager_dispatch():
    """2.5 MB of english and 0.3 MB of mixed text in one plan (1 MiB
    chunks): the pass after the one that caches the counts captures one
    graph per chunk; three replayed passes give the eager dispatch's ids
    and the cold arrays, with one replay per graph, one host read, no Stage
    A run, no merge round and no scan launch by the wrapper, and the scans
    the graphs recorded."""
    if not torch.cuda.is_available():
        pytest.skip("needs an H100")
    enc = Encodings.new_default_encoding_registry().get_encoding(EncodingType.CL100K_BASE)
    engine = DeviceEngine.from_oracle(enc.oracle, native_long=False)
    docs = (corpus.generate(2.5, seed=31, flavor="english")
            + corpus.generate(0.3, seed=32, flavor="mixed"))
    plan = engine.preload_corpus(docs)
    assert engine.count_tokens_corpus(docs, plan=plan) > 0
    cold = engine.encode_ordinary_batch_arrays(None, plan=plan)
    assert plan.encode_graphs is None
    captured = engine.encode_ordinary_batch_arrays(None, plan=plan)
    graphs = plan.encode_graphs
    assert graphs and len(graphs) == len(plan) >= 3
    assert all(g.graph is not None and g.n_scans == 5 for g in graphs)
    assert plan.encode_pool_bytes > 0 and plan.encode_capture_seconds > 0
    eager = _eager_ids(engine, plan)
    for k in range(3):
        before = (engine.graph_replays, engine.host_reads, engine.stage_a_runs,
                  merge.MERGE_ROUNDS, scan.KERNEL_LAUNCHES, scan.REPLAYED_SCANS)
        arrays = engine.encode_ordinary_batch_arrays(None, plan=plan)
        after = (engine.graph_replays, engine.host_reads, engine.stage_a_runs,
                 merge.MERGE_ROUNDS, scan.KERNEL_LAUNCHES, scan.REPLAYED_SCANS)
        assert [a - b for a, b in zip(after, before)] == [
            len(graphs), 1, 0, 0, 0, sum(g.n_scans for g in graphs)], f"pass {k}"
        assert all(np.array_equal(a, b) for a, b in zip(arrays, cold)), f"pass {k}"
        assert all(np.array_equal(a, b) for a, b in zip(captured, cold))
        replayed = [g.out[0][:n].cpu().numpy() for g, n in zip(graphs, plan.n_tokens)]
        assert all(np.array_equal(a, b) for a, b in zip(replayed, eager)), f"pass {k}"
    assert plan.encode_graphs is graphs


@pytest.mark.gpu
def test_wide_replays_equal_the_eager_dispatch():
    """An engine with long pieces on the device merge over 0.2 MB of cjk and
    0.3 MB of mixed text, whose buckets of 64 lanes and more the JAX package
    gives its wide-bucket merge and the port its one merge kernel: its
    warmed count replays one graph per block and its warmed encode one
    graph per chunk; each replayed pass reads once, launches no scan and
    runs no merge round by the wrapper, and its ids equal the eager
    dispatch's, chunk by chunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs an H100")
    enc = Encodings.new_default_encoding_registry().get_encoding(EncodingType.CL100K_BASE)
    engine = DeviceEngine.from_oracle(enc.oracle, native_long=False)
    docs = (corpus.generate(0.2, seed=33, flavor="cjk")
            + corpus.generate(0.3, seed=34, flavor="mixed"))
    plan = engine.preload_corpus(docs)
    total = engine.count_tokens_corpus(docs, plan=plan)
    assert any(lanes >= 64 for c in plan.chunk_cache for _b, lanes, _c, _n in c["caps"])
    cold = engine.encode_ordinary_batch_arrays(None, plan=plan)  # caches the counts
    assert sum(len(a) for a in cold) == total
    assert engine.count_tokens_corpus(None, plan=plan) == total  # captures the count
    captured = engine.encode_ordinary_batch_arrays(None, plan=plan)  # captures the encode
    blocks, graphs = plan.mapped_count, plan.encode_graphs
    assert blocks and all(b.graph is not None for b in blocks)
    assert graphs and len(graphs) == len(plan) and all(g.graph is not None for g in graphs)
    assert all(g.n_scans == 5 for g in graphs) and sum(g.n_rounds for g in graphs) > 0
    assert all(np.array_equal(a, b) for a, b in zip(captured, cold))
    eager = _eager_ids(engine, plan)

    def counters():
        return (engine.graph_replays, engine.host_reads, engine.stage_a_runs,
                merge.MERGE_ROUNDS, scan.KERNEL_LAUNCHES)

    for k in range(3):
        before = counters()
        assert engine.count_tokens_corpus(None, plan=plan) == total, f"pass {k}"
        assert [a - b for a, b in zip(counters(), before)] == [len(blocks), 1, 0, 0, 0]
        before = counters()
        arrays = engine.encode_ordinary_batch_arrays(None, plan=plan)
        assert [a - b for a, b in zip(counters(), before)] == [len(graphs), 1, 0, 0, 0]
        assert all(np.array_equal(a, b) for a, b in zip(arrays, cold)), f"pass {k}"
        replayed = [g.out[0][:n].cpu().numpy() for g, n in zip(graphs, plan.n_tokens)]
        assert all(np.array_equal(a, b) for a, b in zip(replayed, eager)), f"pass {k}"
