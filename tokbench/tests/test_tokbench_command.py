"""The measured command fails, and prints no result, where it cannot
measure: without a CUDA card, for an unknown cell, and in a directory that
holds only BENCHMARK.json and the benchmark's files."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from .conftest import REPO


def command(cwd, *args):
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        cmd = json.load(f)["command"]
    return subprocess.run(
        [sys.executable if cmd[0] == "python3" else cmd[0], *cmd[1:], *args],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def _no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


def test_fails_without_a_card_and_prints_no_result():
    _no_card()
    r = command(REPO, "--workload", "books-cl100k-encode", "--seed", str(2**31 + 3),
                "--seconds", "1", "--trace", "0")
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_fails_for_an_unknown_cell():
    r = command(REPO, "--workload", "no-such-cell", "--seed", "1", "--seconds", "1")
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_fails_with_only_the_benchmark_files(tmp_path):
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "tokbench"), tmp_path / "tokbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = command(str(tmp_path), "--workload", "books-cl100k-encode", "--seed", "1",
                "--seconds", "1", "--trace", "0")
    assert r.returncode != 0 and r.stdout.strip() == ""
