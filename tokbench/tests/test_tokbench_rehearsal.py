"""Each cell's run rehearsed at a tiny size on the port with ``device="cpu"``
and judged by the reference; the faults a cell can have, planted under the
timed path, and the control in the program's place each read not
correct; a cell added from files alone runs."""

import json
import os

import numpy as np
import pytest

from tokbench import control, harness

CELLS = ["books-cl100k-encode", "web-r50k-encode", "books-cl100k-count"]


def run(root, cell, seed=2**31 + 11, seconds=1.0, trace=False, wrap=None):
    return harness.run_cell(cell, seed, seconds, trace, device="cpu", root=root,
                            wrap=wrap)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_rehearsed_on_the_cpu_is_correct(tiny_root, bench, cell):
    r = run(tiny_root, cell)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    assert all(c.get("value") is not None for c in r["checks"].values())
    want = {m["name"] for m in bench["end_to_end"] if harness.applies(m, cell)}
    assert set(r["metrics"]) == want
    # a CPU run reports no device: no busy time, no trace metric
    assert r["device"]["platform"] == "cpu"
    t = run(tiny_root, cell, trace=True)
    assert t["correct"] is True
    assert "busy_s" not in t["device"] and "breakdown" not in t
    counters = {m["name"] for m in bench["per_layer"]
                if harness.applies(m, cell) and m["source"] == "program_counter"}
    assert set(t["metrics"]) == counters


def stale(call):
    """A step that returns its state unchanged: every call answers with
    the previous call's answer."""
    last = []

    def f(batch):
        ans = call(batch)
        out = last[0] if last else ans
        last[:] = [ans]
        return out
    return f


def half(call):
    """Half of the batch left out: the second half's documents answered
    empty."""
    def f(batch):
        k = len(batch) // 2 or 1
        ans = call(batch[:k])
        empty = 0 if isinstance(ans[0], int) else np.zeros(0, np.int32)
        return ans + [empty] * (len(batch) - k)
    return f


def altered(call):
    """One token (or one count) of each call altered where it is produced."""
    def f(batch):
        ans = call(batch)
        i = max(range(len(ans)), key=lambda k: len(batch[k]))
        if isinstance(ans[i], int):
            ans[i] += 1
        else:
            ans[i] = ans[i].copy()
            ans[i][len(ans[i]) // 2] += 1
        return ans
    return f


@pytest.mark.parametrize("cell", ["books-cl100k-encode", "books-cl100k-count"])
@pytest.mark.parametrize("fault", [stale, half, altered])
def test_planted_fault_reads_not_correct(tiny_root, cell, fault):
    r = run(tiny_root, cell, wrap=fault)
    assert r["correct"] is False and r["failed"] > 0, r["checks"]


@pytest.mark.parametrize("cell", ["books-cl100k-encode", "web-r50k-encode",
                                  "books-cl100k-count"])
def test_control_reads_not_correct(tiny_root, cell):
    for r in control.run(cell, [3, 2**32 + 5], 1.0, device="cpu", root=tiny_root):
        assert r["correct"] is False
        assert r["checks"]["reference_mismatch"]["value"] > 0
        assert r["checks"]["repeat_mismatch"]["value"] == 0
        if "roundtrip_mismatch" in r["checks"]:
            assert r["checks"]["roundtrip_mismatch"]["value"] == 0


def test_a_cell_added_from_files_alone_runs(tiny_root, tmp_path):
    """The multilingual mix, kept as data (``traffic/multilingual-encode.json``,
    ``text/*.json``), becomes a cell by an entry in BENCHMARK.json alone, and
    the reference then compares a document of each of its scripts; a count
    of web documents the same way."""
    import shutil

    root = str(tmp_path / "root")
    shutil.copytree(tiny_root, root)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    added = {"books-cl100k-multilingual-encode": ("cl100k-books", "multilingual-encode"),
             "web-r50k-count": ("r50k-web", "count")}
    for name, (config, traffic) in added.items():
        bench["workloads"].append({"name": name, "config": config, "traffic": traffic,
                                   "chips": 1, "why": "a test"})
        kind = "count" if traffic == "count" else "encode"
        for m in bench["end_to_end"] + bench["per_layer"]:
            if m["name"].split("_")[0] == kind or m["name"].endswith("." + kind):
                m["workloads"].append(name)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    r = run(root, "books-cl100k-multilingual-encode")
    assert r["correct"] is True
    assert r["checks"]["reference_scripts"] == {"value": 3, "min": 3}
    assert set(r["metrics"]) == {"encode_MBps", "encode_p95_ms", "setup_s"}
    r = run(root, "web-r50k-count")
    assert r["correct"] is True
    assert set(r["metrics"]) == {"count_MBps", "setup_s"}
