"""The ``codex-p50k-encode`` cell: its run rehearsed at a tiny size on the
port with ``device="cpu"`` and judged by the reference, the control in the
program's place reading not correct, its entries and the readers it adds,
and its ring: the text keeps the statistics of the files its lines came
from, and the files were kept by Codex's filters."""

import json
import os

import pytest

from tokbench import control, harness, ring
from tokbench.harness import Context
from tokbench.reference import Reference
from tokbench.text import make_python

from .conftest import REPO, make_tiny_root

CELL = "codex-p50k-encode"
CONFIG = "p50k-codex-python"
SCRIPTS = ["python-stdlib", "python-stdlib-nonascii"]
ENCODE_CELLS = ["books-cl100k-encode", "web-r50k-encode", "culturax-cl100k-encode", CELL]
NEW = {"retried_chunks_per_call.encode": ("chunks/call", "engine host path"),
       "capacity_retry_ms_per_call.encode": ("ms/call", "kernels"),
       "unicode_chunks_per_call.encode": ("chunks/call", "kernels"),
       "pieces_per_call.encode": ("pieces/call", "kernels")}
# the lists a benchmark test pins (test_tokbench_wide_docs.py,
# test_tokbench_culturax.py): the cell is not in them
PINNED = {"wide_docs_per_call.encode", "host_chunks_ms_per_call.encode",
          "capacity_retries_per_call.encode", "merge_rounds_per_call.encode",
          "miss_pieces_per_call.encode"}


@pytest.fixture(scope="module")
def codex_root(tmp_path_factory):
    """Tiny files (median 512 B, at most 2 KiB) in a ring of 64 KiB: at 35
    files to 1 it holds files of both scripts. Batches under 8 KiB keep a
    call on the CPU near 0.15 s, so that a window of 3 s calls every batch
    and the check meets both scripts."""
    return make_tiny_root(tmp_path_factory.mktemp("codex"), batch=8000, median=512,
                          max_bytes=2048, ring=65536, batches=4)


def run(root, seed=2**31 + 23, seconds=3.0, trace=False):
    return harness.run_cell(CELL, seed, seconds, trace, device="cpu", root=root)


def test_cell_rehearsed_on_the_cpu_is_correct(codex_root, bench):
    r = run(codex_root)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert r["checks"]["reference_scripts"] == {"value": 2, "min": 2}
    assert r["checks"]["reference_mismatch"]["value"] == 0
    assert set(r["metrics"]) == {"encode_MBps", "encode_p95_ms", "setup_s"}
    t = run(codex_root, seed=7, trace=True)
    assert t["correct"] is True
    counters = {m["name"] for m in bench["per_layer"]
                if harness.applies(m, CELL) and m["source"] == "program_counter"}
    assert set(NEW) <= counters
    assert set(t["metrics"]) == counters
    value = lambda name: t["metrics"][name]["value"]
    assert value("pieces_per_call.encode") > 0
    assert value("native_chunks_per_call.encode") == 0
    # 8 KiB of code misses the ASCII chunk's 256-row primary miss table
    assert value("retried_chunks_per_call.encode") > 0
    assert value("capacity_retry_ms_per_call.encode") > 0
    assert value("graph_captures.encode") == 0


def test_control_reads_not_correct(codex_root):
    for r in control.run(CELL, [3, 2**32 + 5], 3.0, device="cpu", root=codex_root):
        assert r["correct"] is False
        assert r["checks"]["reference_mismatch"]["value"] > 0
        assert r["checks"]["repeat_mismatch"]["value"] == 0
        assert r["checks"]["roundtrip_mismatch"]["value"] == 0


def test_the_cell_and_its_metrics_are_declared(bench):
    (w,) = [w for w in bench["workloads"] if w["name"] == CELL]
    assert (w["config"], w["traffic"], w["chips"]) == (CONFIG, "codex-encode", 1)
    (cfg,) = [c for c in bench["configs"] if c["name"] == CONFIG]
    assert cfg["reduced"] == [] and len(cfg["source"]) <= 200
    assert all(s in cfg["source"] for s in ("Codex", "2107.03374", "p50k_base"))
    c = harness.load_cell(CELL)
    assert (c.config["encoding"], c.config["pattern"]) == ("p50k_base", "gpt2")
    assert c.config["documents"] == {"median_bytes": 7612, "sigma": 1.6,
                                     "min_bytes": 64, "max_bytes": 1048576,
                                     "wrap_rate": 1.0}
    assert (c.traffic["entry"], c.traffic["scripts"]) == (
        "encode_arrays", {"python-stdlib": 35, "python-stdlib-nonascii": 1})
    by_name = {m["name"]: m for m in bench["end_to_end"] + bench["per_layer"]}
    for name in ("encode_MBps", "encode_p95_ms"):
        assert CELL in by_name[name]["workloads"]
    for m in bench["per_layer"]:
        if m["name"].endswith(".encode"):
            assert (CELL in m["workloads"]) == (m["name"] not in PINNED), m["name"]
    for name, (unit, layer) in NEW.items():
        m = by_name[name]
        assert (m["unit"], m["layer"], m["moves"], m["source"]) == (
            unit, layer, "encode_MBps", "program_counter")
        assert m["workloads"] == ENCODE_CELLS
    # appended last, in this order
    assert [m["name"] for m in bench["per_layer"][-4:]] == list(NEW)


def test_new_readers_read_their_counters_or_nothing():
    before = {"retried_chunks": 2, "capacity_retry_ns": 1_000_000,
              "unicode_chunks": 5, "pieces": 100}
    after = {"retried_chunks": 14, "capacity_retry_ns": 41_000_000,
             "unicode_chunks": 35, "pieces": 9_600_100}
    ctx = Context("encode", 10, before, after)
    read = lambda name: harness.read_metric(name, ctx, harness.ROOT)
    assert read("retried_chunks_per_call.encode") == pytest.approx(1.2)
    assert read("capacity_retry_ms_per_call.encode") == pytest.approx(4.0)
    assert read("unicode_chunks_per_call.encode") == pytest.approx(3.0)
    assert read("pieces_per_call.encode") == pytest.approx(960_000.0)
    # a program that keeps none of these counters (a port older than them)
    # reads nothing, and no reader raises
    ctx.before, ctx.after = {"capacity_retries": 0}, {"capacity_retries": 1}
    for name in NEW:
        assert read(name) is None


# ----------------------------------------------------------------------
# the text
# ----------------------------------------------------------------------

def _pool_text(script: str, seed: int, n_bytes: int) -> str:
    """``n_bytes`` of whole phrases of the script as the cell draws them."""
    spec = ring.load_text_spec(script)
    pool = ring.phrase_pool(spec, ring.rng_for(seed, 2), 1.0)
    out, size = [], 0
    for p in pool:
        out.append(p)
        size += len(p)
        if size >= n_bytes:
            break
    return b"".join(out).decode("utf-8")


@pytest.mark.parametrize("script", SCRIPTS)
def test_ring_text_keeps_its_files_statistics(script):
    """The generator's text, whole lines joined by newlines, reads within 5 %
    of the files the lines came from (``source_stats``, by the same
    reference) in bytes a token and pieces for the merge a MiB."""
    spec = ring.load_text_spec(script)
    text = _pool_text(script, 2**31 + 3, 300_000)
    ref = Reference(os.path.join(REPO, "jtokkit_tpu/vocab/assets/p50k_base.tiktoken"),
                    "gpt2")
    got = make_python.stats([text], ref)
    want = spec["source_stats"]
    for key in ("bytes_per_token", "misses_per_mib"):
        assert got[key] == pytest.approx(want[key], rel=0.05), key
    for key in ("one_token_pieces", "whitespace_pieces"):
        assert got[key] == pytest.approx(want[key], abs=0.02), key


def test_text_files_are_lines_of_the_kept_files():
    for script in SCRIPTS:
        spec = ring.load_text_spec(script)
        assert spec["kind"] == "sentences" and spec["punctuation"] == ["\n"]
        assert spec["sentence_words"] == [1, 16] and spec["number_below"] == 1
        assert all("\n" not in w for w in spec["words"])
        rates = [v for k, v in spec.items() if k.endswith("_rate")]
        assert rates and not any(rates)
        assert "Python Software Foundation" in spec["about"]
    ascii_words = ring.load_text_spec(SCRIPTS[0])["words"]
    other = ring.load_text_spec(SCRIPTS[1])["words"]
    assert len(ascii_words) == make_python.ASCII_LINES
    assert all(w.isascii() for w in ascii_words)
    assert any(not w.isascii() for w in other)
    # indentation and repeats kept
    assert any(w.startswith("        ") for w in ascii_words)
    assert len(set(ascii_words)) < len(ascii_words)


def test_codex_filters():
    lines = lambda n, width: "\n".join("x" * width for _ in range(n)) + "\n"
    keep = '"""A module.\n\n    A tree can be generated by passing a flag.\n"""\nx = 1\n'
    assert make_python.codex_filter("ast.py", keep) is None
    assert make_python.codex_filter("a.py", lines(10, 120)) == "average line length over 100"
    assert make_python.codex_filter("a.py", lines(1, 1001) + lines(50, 10)) == (
        "longest line over 1000")
    assert make_python.codex_filter("a.py", "#" * 80 + "\nx = 1\n") == (
        "alphanumeric share under 0.25")
    for head in ("# Auto-generated by Tools/build/generate_token.py",
                 "# Autogenerated by Sphinx",
                 '""" Python Character Mapping Codec cp037 generated from \'CP037.TXT\'',
                 "# system configuration generated and used by the sysconfig module"):
        assert make_python.codex_filter("a.py", head + "\nx = 1\n") == "generated"
    head = '"""Parser engine for the grammar tables generated by pgen.\n"""\nx = 1\n'
    assert make_python.codex_filter("lib2to3/pgen2/parse.py", head) is None
    assert make_python.source_lines("a\n  b\n\nc  \n") == ["a", "  b", "", "c  "]


def test_full_size_plan_follows_the_shares():
    """The document plan at full size: file counts 35 : 1, ~150 files a
    4 MiB batch, no file over 1 MiB."""
    c = harness.load_cell(CELL)
    lengths, scripts = ring.document_plan(c.config["documents"], c.traffic)
    assert (scripts == SCRIPTS[1]).mean() == pytest.approx(1 / 36, abs=1e-3)
    assert lengths.max() <= 1 << 20 and lengths.min() >= 64
    per_batch = c.traffic["batch_bytes"] / lengths.mean()
    assert 120 < per_batch < 180
    with open(os.path.join(REPO, "tokbench", "text", "python-stdlib.json")) as f:
        assert json.load(f)["source_stats"]["longest_piece"] < 4096
