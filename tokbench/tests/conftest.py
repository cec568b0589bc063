"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's files
at a size a test run can hold. Nothing here imports JAX."""

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def make_tiny_root(dst, batch=16384, median=2048, max_bytes=16384, ring=65536,
                   batches=4):
    """The benchmark's files under ``dst`` with small documents, batches and
    rings, the rank files named by absolute path."""
    shutil.copytree(os.path.join(REPO, "tokbench"), os.path.join(dst, "tokbench"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for c in bench["configs"]:
        path = os.path.join(dst, c["file"])
        with open(path) as f:
            cfg = json.load(f)
        cfg["vocab_file"] = os.path.join(REPO, cfg["vocab_file"])
        d = cfg["documents"]
        scale = min(1.0, median / d["median_bytes"])
        d["median_bytes"] = max(64, int(d["median_bytes"] * scale))
        d["min_bytes"] = max(16, int(d["min_bytes"] * scale))
        d["max_bytes"] = min(max_bytes, d["max_bytes"])
        with open(path, "w") as f:
            json.dump(cfg, f)
    traffic_dir = os.path.join(dst, "tokbench", "traffic")
    for name in os.listdir(traffic_dir):
        path = os.path.join(traffic_dir, name)
        with open(path) as f:
            t = json.load(f)
        t.update(batch_bytes=batch, ring_min_bytes=ring, ring_min_batches=batches)
        with open(path, "w") as f:
            json.dump(t, f)
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return str(dst)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("tokbench"))


@pytest.fixture(scope="session")
def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)
