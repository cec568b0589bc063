"""The command on a CUDA card: one short run of a cell without and with
the trace, each printing the contract's last line. Runs on the card with
``python -m pytest tokbench/tests/test_tokbench_card.py``; skips without
one."""

import json

import pytest

from .test_tokbench_command import command, REPO


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_prints_the_line(bench, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = "books-cl100k-encode"
    r = command(REPO, "--workload", cell, "--seed", str(2**31 + 17), "--seconds", "3",
                "--trace", str(trace))
    assert r.returncode == 0, r.stderr[-4000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["kind"] == torch.cuda.get_device_name(0)
    assert dev["memory_peak_bytes"] > 0
    group = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in bench[group] if "workloads" not in m or cell in m["workloads"]}
    assert set(line["metrics"]) == want
    assert all(v["value"] is not None for v in line["metrics"].values())
    assert r.stderr.strip().splitlines()[-1].startswith("check ")
    if trace:
        assert 0 < dev["busy_s"] <= dev["window_s"]
        assert 0 < len(line["breakdown"]["device_ops"]) <= 10
        assert len(line["breakdown"]["idle_gaps"]) <= 10
        assert 0 < line["metrics"]["kernels_roofline.encode"]["value"] <= 100
