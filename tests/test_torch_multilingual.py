"""The port on multilingual web text: the scripts of the benchmark's
``culturax-cl100k-encode`` cell (``tokbench/text/latin-eu.json``,
``cyrillic.json``, ``cjk-web.json``) and a small ring of its mix, against
the benchmark's plain reference (``tokbench/reference/``) and the JAX
engine, document by document.

Also the paths that only non-ASCII text reaches: the ``"unicode"`` Stage A
variant with its roomier miss table, a forced capacity retry, and the
engine's ``merge_rounds`` and ``miss_pieces`` counters against the merge
loops' own count, the plan's cached rounds and the metas.

Port engines run on the CPU (``device="cpu"``) with chunks of 64 KiB; the
text is seeded. Every comparison is exact (integer ids: tolerance 0).
"""

import json
import os

import numpy as np
import pytest
import torch

from jtokkit_tpu_torch.engine import device as device_mod
from jtokkit_tpu_torch.engine.device import DeviceEngine
from jtokkit_tpu_torch.ops import merge
from tokbench import ring
from tokbench.reference import Reference

from .test_torch_engine import engines

# The suite runs in several worker processes at once; torch's own thread
# pool in each of them would oversubscribe the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = 1 << 16
SCRIPTS = ["latin-eu", "cyrillic", "cjk-web"]
_CACHE = {}


def reference() -> Reference:
    if "ref" not in _CACHE:
        _CACHE["ref"] = Reference(
            os.path.join(REPO, "jtokkit_tpu/vocab/assets/cl100k_base.tiktoken"),
            "cl100k")
    return _CACHE["ref"]


def port(**kw) -> DeviceEngine:
    """A fresh CPU engine over cl100k with 64 KiB chunks (fresh, so that
    its counters start at 0)."""
    return DeviceEngine.from_oracle(engines("cl100k_base")[2].oracle,
                                    device="cpu", chunk_bytes=SMALL, **kw)


def script_docs(script: str, seed: int, n_bytes: int = 150_000):
    """Documents of 200-4,000 bytes of one script's text, whole phrases
    drawn by the benchmark's generator, about ``n_bytes`` in all."""
    spec = ring.load_text_spec(script)
    rng = ring.rng_for(seed, 7)
    draw = (ring._sentences(spec, 0.0) if spec["kind"] == "sentences"
            else ring._runs(spec))
    sizes = rng.integers(200, 4000, 4096).tolist()
    out, cur, total = [], b"", 0
    for phrase in draw(rng, 8192):
        cur += phrase
        if len(cur) >= sizes[len(out)]:
            out.append(cur.decode("utf-8"))
            total += len(cur)
            cur = b""
            if total >= n_bytes:
                break
    return out


def check_docs(texts, got):
    """``got`` (arrays or lists per document) against the reference and the
    JAX engine, document by document."""
    ref = reference()
    want_jax = engines("cl100k_base")[1].encode_ordinary_batch(texts)
    assert len(got) == len(texts) == len(want_jax)
    for t, g, j in zip(texts, got, want_jax):
        np.testing.assert_array_equal(np.asarray(g, np.int64), ref.encode(t), err_msg=t[:80])
        assert list(map(int, g)) == j


def reference_misses(texts) -> int:
    """Pieces that are not one token of at most 16 bytes (the word table's
    rows): the ones Stage A sends to the merge."""
    ref = reference()
    n = 0
    for t in texts:
        for a, b in ref.split(t):
            p = t[a:b].encode("utf-8")
            n += not (len(p) <= 16 and p in ref.ranks)
    return n


def spy_variants(monkeypatch, eng):
    """Record (variant, divs) of every chunk ``eng`` stages."""
    seen = []
    stage = eng._stage_chunk

    def spy(*args):
        s = stage(*args)
        seen.append((s[3], s[8]))
        return s

    monkeypatch.setattr(eng, "_stage_chunk", spy)
    return seen


@pytest.mark.parametrize("script", SCRIPTS + ["english"])
def test_script_text_equals_both_references(monkeypatch, script):
    """Each script over several 64 KiB chunks; a chunk with a non-ASCII
    byte takes the ``"unicode"`` Stage A at its roomier miss table, an
    English one the ASCII variant."""
    texts = script_docs(script, seed=2**31 + 17)
    eng = port(native_long=False)
    seen = spy_variants(monkeypatch, eng)
    got = eng.encode_ordinary_batch_arrays(texts)
    check_docs(texts, got)
    assert len(seen) >= 2
    if script == "english":
        assert set(seen) == {("ascii", device_mod._DIVS_PRIMARY)}
    else:
        assert set(seen) == {("unicode", device_mod._DIVS_PRIMARY_UNICODE)}
    assert eng.capacity_retries == 0 and eng.fallback_chunks == 0
    assert eng.count_tokens_batch(texts) == [len(g) for g in got]


@pytest.mark.parametrize("script", ["cyrillic", "cjk-web"])
def test_forced_capacity_retry_is_exact(monkeypatch, script):
    """A unicode miss table of 16 rows a 64 KiB chunk overflows on every
    chunk: each runs Stage A again at the roomy capacities, in one more
    metas read, and the ids stay exact."""
    monkeypatch.setattr(device_mod, "_DIVS_PRIMARY_UNICODE", (4, 4096))
    texts = script_docs(script, seed=5, n_bytes=100_000)
    eng = port(native_long=False)
    seen = spy_variants(monkeypatch, eng)
    got = eng.encode_ordinary_batch_arrays(texts)
    check_docs(texts, got)
    assert set(seen) == {("unicode", (4, 4096))}
    assert eng.capacity_retries == 1
    assert eng.stage_a_runs == 2 * len(seen)
    assert eng.fallback_chunks == 0


@pytest.mark.parametrize("cold_cache", [False, True])
@pytest.mark.parametrize("script", SCRIPTS)
def test_merge_counters_equal_the_loops_and_the_metas(monkeypatch, script, cold_cache):
    """``merge_rounds`` gains what the merge loops ran (``merge.MERGE_ROUNDS``
    for the eager loops, the device loops' counters read back with the last
    read from the graph cache's units) and equals the rounds the plan
    caches per bucket; ``miss_pieces`` gains the bucket counts of the metas
    of every chunk routed to Stages B-C, which are the reference's misses."""
    texts = script_docs(script, seed=11, n_bytes=120_000)
    eng = port(native_long=False, cold_cache=cold_cache)
    metas = []
    run_b_c = eng._run_stages_b_c

    def spy(staged, m, want_tokens):
        metas.append(np.array(m))
        return run_b_c(staged, m, want_tokens)

    monkeypatch.setattr(eng, "_run_stages_b_c", spy)
    plan = eng.preload_corpus(texts)
    rounds = merge.MERGE_ROUNDS
    got = eng.encode_ordinary_batch_arrays(texts, plan=plan)
    check_docs(texts, got)
    cached = [c for c in plan.chunk_cache if c["kind"] == "ok"]
    assert len(cached) == len(plan) >= 2
    plan_rounds = sum(sum(r) if isinstance(r, tuple) else r
                      for c in cached for r in c["rounds"])
    assert eng.merge_rounds == merge.MERGE_ROUNDS - rounds == plan_rounds > 0
    (m,) = metas
    assert eng.miss_pieces == int(m[:, 2:].sum()) == reference_misses(texts)
    assert eng.miss_pieces == sum(n for c in cached for _b, _l, _c, n in c["caps"])
    # the same text un-planned: the same counts again
    eng.encode_ordinary_batch_arrays(texts)
    assert eng.merge_rounds == 2 * plan_rounds
    assert eng.miss_pieces == 2 * reference_misses(texts)


def small_ring(seed: int):
    """The cell's configuration and traffic cut to batches of 160 KiB (a few
    64 KiB chunks) and documents of at most 8 KiB."""
    with open(os.path.join(REPO, "tokbench/configs/cl100k-culturax.json")) as f:
        config = json.load(f)
    with open(os.path.join(REPO, "tokbench/traffic/culturax-encode.json")) as f:
        traffic = json.load(f)
    config["documents"].update(median_bytes=600, max_bytes=8192)
    traffic.update(batch_bytes=160 * 1024, ring_min_batches=2,
                   ring_min_bytes=320 * 1024)
    return ring.build_ring(config, traffic, seed, os.path.join(REPO, "tokbench"))


def test_mixed_ring_equals_both_references():
    """Every batch of a small ring of the cell's mix through the port's
    default routing, against both references; the counters move."""
    r = small_ring(2**31 + 3)
    assert {s for x in r.scripts for s in x} == {"english", "latin-eu", "cyrillic",
                                                 "cjk-web"}
    eng = port()
    for batch in r.batches:
        check_docs(batch, eng.encode_ordinary_batch_arrays(batch))
    assert eng.miss_pieces > 0 and eng.merge_rounds > 0
    assert eng.capacity_retries == 0
