"""The ``culturax-cl100k-encode`` cell: its run rehearsed at a tiny size on
the port with ``device="cpu"`` and judged by the reference, the control in
the program's place reading not correct, the readers it adds, and its ring:
each script's text follows its script, and every seed gives the same sizes
and script counts."""

import json
import os
import re
import unicodedata

import numpy as np
import pytest

from tokbench import control, harness, ring
from tokbench.harness import Context

CELL = "culturax-cl100k-encode"
SCRIPTS = {"english", "latin-eu", "cyrillic", "cjk-web"}
NEW = ["merge_rounds_per_call.encode", "miss_pieces_per_call.encode",
       "host_chunks_ms_per_call.encode", "capacity_retries_per_call.encode"]


def run(root, seed=2**31 + 23, seconds=1.0, trace=False):
    return harness.run_cell(CELL, seed, seconds, trace, device="cpu", root=root)


def test_cell_rehearsed_on_the_cpu_is_correct(tiny_root, bench):
    r = run(tiny_root)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert r["checks"]["reference_scripts"] == {"value": 4, "min": 4}
    assert r["checks"]["reference_mismatch"]["value"] == 0
    assert set(r["metrics"]) == {"encode_MBps", "encode_p95_ms", "setup_s"}
    t = run(tiny_root, seed=7, trace=True)
    assert t["correct"] is True
    counters = {m["name"] for m in bench["per_layer"]
                if harness.applies(m, CELL) and m["source"] == "program_counter"}
    assert set(NEW) <= counters
    assert set(t["metrics"]) == counters
    assert t["metrics"]["merge_rounds_per_call.encode"]["value"] > 0
    assert t["metrics"]["miss_pieces_per_call.encode"]["value"] > 0
    assert t["metrics"]["capacity_retries_per_call.encode"]["value"] == 0


def test_control_reads_not_correct(tiny_root):
    for r in control.run(CELL, [3, 2**32 + 5], 1.0, device="cpu", root=tiny_root):
        assert r["correct"] is False
        assert r["checks"]["reference_mismatch"]["value"] > 0
        assert r["checks"]["repeat_mismatch"]["value"] == 0
        assert r["checks"]["roundtrip_mismatch"]["value"] == 0


def test_the_cell_and_its_metrics_are_declared(bench):
    (w,) = [w for w in bench["workloads"] if w["name"] == CELL]
    assert (w["config"], w["traffic"], w["chips"]) == ("cl100k-culturax",
                                                      "culturax-encode", 1)
    (cfg,) = [c for c in bench["configs"] if c["name"] == "cl100k-culturax"]
    assert cfg["reduced"] == [] and len(cfg["source"]) <= 200
    assert all(s in cfg["source"] for s in ("CulturaX", "2309.09400", "cl100k_base"))
    by_name = {m["name"]: m for m in bench["end_to_end"] + bench["per_layer"]}
    for m in bench["per_layer"]:
        if m["name"].endswith(".encode"):
            assert CELL in m["workloads"], m["name"]
    for name in ("encode_MBps", "encode_p95_ms"):
        assert CELL in by_name[name]["workloads"]
    for name in NEW[:2]:
        assert by_name[name]["workloads"] == ["books-cl100k-encode",
                                              "web-r50k-encode", CELL]
    for name in NEW[2:]:
        assert by_name[name]["workloads"] == [CELL]
    for name in NEW:
        assert by_name[name]["moves"] == "encode_MBps"
        assert by_name[name]["source"] == "program_counter"


def test_new_readers_read_their_counters_or_nothing():
    before = {"merge_rounds": 100, "miss_pieces": 50, "host_chunks_ns": 0,
              "capacity_retries": 1}
    after = {"merge_rounds": 1100, "miss_pieces": 2050, "host_chunks_ns": 30_000_000,
             "capacity_retries": 3}
    ctx = Context("encode", 10, before, after)
    read = lambda name: harness.read_metric(name, ctx, harness.ROOT)
    assert read("merge_rounds_per_call.encode") == pytest.approx(100.0)
    assert read("miss_pieces_per_call.encode") == pytest.approx(200.0)
    assert read("host_chunks_ms_per_call.encode") == pytest.approx(3.0)
    assert read("capacity_retries_per_call.encode") == pytest.approx(0.2)
    # a program that keeps no such counter (a port older than the counters)
    # reads nothing, and no reader raises
    ctx.before, ctx.after = {"capacity_retries": 0}, {"capacity_retries": 0}
    assert read("merge_rounds_per_call.encode") is None
    assert read("miss_pieces_per_call.encode") is None
    assert read("host_chunks_ms_per_call.encode") is None


# ----------------------------------------------------------------------
# the ring
# ----------------------------------------------------------------------

def _pool_text(script: str, seed: int, n: int = 3000) -> str:
    pool = ring.phrase_pool(ring.load_text_spec(script), ring.rng_for(seed, 2))
    return b"".join(pool[:n]).decode("utf-8")


def _letters(text: str):
    return [ch for ch in text if ch.isalpha()]


def test_latin_text_is_accented_latin_and_follows_its_words():
    spec = ring.load_text_spec("latin-eu")
    assert len(set(spec["words"])) >= 300
    text = _pool_text("latin-eu", 1)
    letters = _letters(text)
    assert all(unicodedata.name(ch).startswith("LATIN") for ch in letters)
    accented = set(ch for ch in letters if not ch.isascii())
    assert set("áéíóúñüöäßçàèêôãõąęłśźżćń") <= accented
    assert set("¿¡«»„\"") <= set(text)
    words = set(spec["words"])
    tokens = [w.strip(".,;:!?¿¡«»„“\"\n") for w in text.split()]
    assert sum(w in words or w.lower() in words or w.isdigit()
               for w in tokens) > 0.95 * len(tokens)
    # the generator capitalises ASCII only: capitalised forms of words that
    # start with another letter are words of their own
    assert {"Über", "Él", "À", "Że"} <= words


def test_cyrillic_text_is_cyrillic():
    spec = ring.load_text_spec("cyrillic")
    assert len(set(spec["words"])) >= 300
    letters = _letters(_pool_text("cyrillic", 2))
    assert all(unicodedata.name(ch).startswith("CYRILLIC") for ch in letters)
    assert any(ch.isupper() for ch in letters)
    lo, hi = spec["sentence_words"]
    assert (lo, hi) == (6, 18)


def test_cjk_web_text_is_clauses_of_its_characters():
    spec = ring.load_text_spec("cjk-web")
    chars = spec["chars"]
    assert len(set(chars)) == len(chars) >= 500
    assert all(unicodedata.name(ch).startswith("CJK UNIFIED IDEOGRAPH") for ch in chars)
    text = _pool_text("cjk-web", 3)
    assert set(text) <= set(chars) | {"，", "。"}
    clauses = [c for c in re.split("[，。]", text) if c]
    assert 4 <= min(map(len, clauses)) and max(map(len, clauses)) <= 30
    ends = [ch for ch in text if ch in "，。"]
    assert 0.5 < ends.count("，") / len(ends) < 0.7


def test_every_seed_gives_the_same_sizes_and_script_counts(tiny_root):
    with open(os.path.join(tiny_root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    (w,) = [w for w in bench["workloads"] if w["name"] == CELL]
    c = harness.cell_from(w, bench, tiny_root)
    root = os.path.join(tiny_root, "tokbench")
    rings = [ring.build_ring(c.config, c.traffic, s, root) for s in (5, 2**31 + 9)]
    make_up = lambda r: sorted((tuple(sorted(s.tolist())), tuple(sorted(x)))
                               for s, x in zip(r.doc_bytes, r.scripts))
    a, b = (make_up(r) for r in rings)
    assert [x for _s, x in a] == [x for _s, x in b]
    for (sa, _x), (sb, _y) in zip(a, b):
        assert np.allclose(sa, sb, atol=3)
    assert rings[0].batches != rings[1].batches
    for r in rings:
        scripts = [s for x in r.scripts for s in x]
        assert set(scripts) == SCRIPTS


def test_full_size_plan_follows_the_shares():
    """The document plan at full size: document counts 9 : 7 : 3 : 1, and
    the bytes in nearly the same ratio, as the lengths are dealt alike."""
    c = harness.load_cell(CELL)
    lengths, scripts = ring.document_plan(c.config["documents"], c.traffic)
    share = {s: (scripts == s).mean() for s in SCRIPTS}
    by_bytes = {s: lengths[scripts == s].sum() / lengths.sum() for s in SCRIPTS}
    for s, k in {"english": 9, "latin-eu": 7, "cyrillic": 3, "cjk-web": 1}.items():
        assert share[s] == pytest.approx(k / 20, abs=1e-3)
        assert by_bytes[s] == pytest.approx(k / 20, abs=0.01)
