"""The port's benchmark module (``jtokkit_tpu_torch/bench.py``) against the
JAX package's (``jtokkit_tpu/bench.py``) on the same seeded corpora, and the
root ``bench.py``'s line contract as ``main`` keeps it.

Token totals are exact: the port's ``device`` and ``device-count`` against
the JAX bench's own device engine (one english corpus; the JAX engine's
first CPU compile takes most of a minute), every other mode against the JAX
bench's ``host`` or ``native`` on english and cjk. The port runs on the CPU
with ``chunk_bytes=1<<17``, as the JAX engine does under
``tests/conftest.py``.
"""

import json
import sys

import pytest
import torch
import torch.distributed as dist

from jtokkit_tpu import bench as jax_bench
from jtokkit_tpu_torch import bench, cli
from jtokkit_tpu_torch.engine.device import DeviceEngine
from jtokkit_tpu_torch.parallel import mesh

# the suite runs in several worker processes at once
torch.set_num_threads(1)

CPU = dict(device="cpu", chunk_bytes=1 << 17)
# english about 0.3 MB (5 documents); cjk one document of about 0.2 MB
MB = {"english": 0.3, "cjk": 0.1}
# the Python oracle takes about 3 s per cjk document: the bench's own
# three-document check runs on english only
VERIFY = {"english": True, "cjk": False}

_PORT = {}
_JAX = {}


def port_run(mode, flavor="english"):
    if (mode, flavor) not in _PORT:
        _PORT[mode, flavor] = bench.run(
            mb=MB[flavor], mode=mode, flavor=flavor, passes=1,
            verify=VERIFY[flavor], **CPU,
        )
    return _PORT[mode, flavor]


def jax_run(mode, flavor="english"):
    if (mode, flavor) not in _JAX:
        _JAX[mode, flavor] = jax_bench.run(
            mb=MB[flavor], mode=mode, flavor=flavor, passes=1,
            verify=VERIFY[flavor],
        )
    return _JAX[mode, flavor]


@pytest.mark.parametrize("mode", ["device-count", "device"])
def test_device_modes_match_the_jax_device_engine(mode):
    got, want = port_run(mode), jax_run(mode)
    assert got["detail"]["tokens"] == want["detail"]["tokens"] > 0
    assert got["metric"] == want["metric"].replace("1 chip", "cpu")


OTHER = [
    (mode, flavor) for flavor in ("english", "cjk") for mode in bench.MODES
    if flavor == "cjk" or mode not in ("device", "device-count")
]


@pytest.mark.parametrize("mode,flavor", OTHER, ids=lambda v: v)
def test_mode_totals_match_the_jax_bench(mode, flavor):
    """Each mode's token total equals the JAX bench's ``host`` (for the
    port's ``host`` on english) or ``native`` on the same corpus."""
    if mode == "tiktoken":
        pytest.importorskip("tiktoken")
    ref = "host" if (mode, flavor) == ("host", "english") else "native"
    got = port_run(mode, flavor)
    assert got["detail"]["tokens"] == jax_run(ref, flavor)["detail"]["tokens"] > 0
    assert got["value"] > 0 and got["detail"]["flavor"] == flavor


@pytest.mark.parametrize("mode", bench.MODES)
def test_result_dict_matches_the_jax_bench(mode):
    """The port's result has the reference's keys; in place of the
    reference's ``backend`` its detail names the torch ``device``."""
    if mode == "tiktoken":
        pytest.importorskip("tiktoken")
    got = port_run(mode)
    want = (jax_run(mode) if mode in ("device", "device-count", "host", "native")
            else jax_run("native"))
    assert set(got) == set(want) == {"metric", "value", "unit", "vs_baseline", "detail"}
    keys = set(want["detail"])
    if mode in ("sharded", "sharded-count"):
        keys |= {"n_devices", "backend"}
    if mode == "native-mt":
        keys.add("threads")
    if mode not in ("host", "native", "native-mt", "tiktoken"):
        keys = keys - {"backend"} | {"device"}
        assert got["detail"]["device"] == "cpu"
    assert set(got["detail"]) == keys
    where = {"sharded": "1-rank group", "sharded-count": "1-rank group",
             "host": "host", "native": "host", "native-mt": "host",
             "tiktoken": "host"}.get(mode, "cpu")
    assert got["metric"] == f"cl100k_base encode throughput ({mode}, {where})"
    assert got["detail"]["baseline_mbps"] == want["detail"]["baseline_mbps"]
    assert got["detail"]["corpus_mb"] == want["detail"]["corpus_mb"]


def test_decode_is_the_host_decode(monkeypatch):
    """``decode`` maps by meaning: the numpy host decode, which is what the
    JAX package's ``decode_bytes_batch`` is; ``device-decode`` is the
    device path."""
    def refuse(*_a, **_k):
        raise AssertionError("the device decode ran")

    monkeypatch.setattr(DeviceEngine, "decode_bytes_batch_device", refuse)
    assert bench.run(mb=0.05, mode="decode", passes=1, **CPU)["detail"]["tokens"] > 0
    with pytest.raises(AssertionError, match="device decode ran"):
        bench.run(mb=0.05, mode="device-decode", passes=1, **CPU)


@pytest.mark.parametrize("mode", ["sharded", "sharded-count"])
def test_sharded_leaves_no_group_behind(mode):
    assert not dist.is_initialized()
    r = bench.run(mb=0.05, mode=mode, passes=1, **CPU)
    assert r["detail"]["n_devices"] == 1 and r["detail"]["device"] == "cpu"
    assert not dist.is_initialized()


@pytest.fixture
def group(tmp_path):
    """A world-1 gloo group of the caller's own, for one test."""
    mesh.initialize_distributed(f"file://{tmp_path}/store", 1, 0, device="cpu")
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("mode", ["sharded", "sharded-count"])
def test_sharded_uses_the_callers_group(group, monkeypatch, mode):
    def refuse(*_a, **_k):
        raise AssertionError("a second group was made")

    monkeypatch.setattr(mesh, "initialize_distributed", refuse)
    r = bench.run(mb=0.05, mode=mode, passes=1, **CPU)
    assert r["metric"].endswith(f"({mode}, 1-rank group)")
    assert dist.is_initialized()


@pytest.mark.parametrize("call", [
    lambda: bench.run(mb=0.05),
    lambda: bench.run(mb=0.05, mode="device-count"),
    lambda: bench.run(mb=0.05, mode="sharded"),
    lambda: bench.run_scaling(mb_per_dev=0.05, sizes=[1]),
    lambda: bench.main(["--mb", "0.05", "--fast"]),
    lambda: cli.main(["bench", "--mb", "0.05"]),
], ids=["run", "run-count", "run-sharded", "run_scaling", "main", "cli"])
def test_without_a_card_the_device_modes_raise(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
    assert not dist.is_initialized()


def test_tiktoken_mode_says_when_the_package_is_missing(monkeypatch):
    monkeypatch.setitem(sys.modules, "tiktoken", None)
    with pytest.raises(ImportError, match="tiktoken package"):
        bench.run(mb=0.05, mode="tiktoken")


def test_run_scaling_on_gloo_ranks():
    """Weak scaling over one and two gloo ranks in child processes: each
    row's total equals the oracle's on its corpus."""
    from jtokkit_tpu.utils.corpus import generate

    rows = bench.run_scaling(mb_per_dev=0.05, sizes=[1, 2], passes=1, **CPU)
    orc = jax_bench._oracle("cl100k_base")
    assert [r["detail"]["n_devices"] for r in rows] == [1, 2]
    assert rows[0]["detail"]["efficiency"] == 1.0
    for n, r in zip((1, 2), rows):
        want = sum(len(orc.encode_ordinary(t)[0])
                   for t in generate(0.05 * n, seed=0, flavor="english"))
        assert r["detail"]["tokens"] == want
        assert r["detail"]["backend"] == "gloo" and r["detail"]["device"] == "cpu"
        assert r["detail"]["scan_launches"] == 0  # the plain versions ran
        assert r["metric"] == "cl100k_base sharded count weak-scaling"


def _lines(capsys, argv):
    bench.main(argv + ["--device", "cpu", "--chunk-bytes", str(1 << 17)])
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


def test_main_prints_the_headline_first_and_last(capsys):
    """Companions under ``--budget 0`` are all skipped by name; the
    augmented headline is the last line."""
    lines = _lines(capsys, ["--mb", "0.2", "--budget", "0"])
    assert len(lines) == 2
    first, last = lines
    assert first["metric"] == "cl100k_base encode throughput (device, cpu)"
    assert "companions" not in first["detail"]
    assert {k: v for k, v in last.items() if k != "detail"} == {
        k: v for k, v in first.items() if k != "detail"}
    companions = last["detail"]["companions"]
    assert [c["metric"] for c in companions] == [
        f"{e} {m} {f}" for e, f, m, _mb in bench.COMPANIONS]
    assert all(c["skipped"] == "budget exhausted" for c in companions)
    assert last["detail"]["companion_budget_s"] == 0


@pytest.mark.parametrize("argv", [
    ["--mb", "0.2", "--fast"],
    ["--mb", "0.2", "--mode", "device-count"],
    ["--smoke"],
], ids=["fast", "not-the-default-headline", "smoke"])
def test_main_prints_one_line_without_companions(capsys, argv):
    (line,) = _lines(capsys, argv)
    assert line["value"] > 0 and "companions" not in line["detail"]
    assert "mode_semantics" in line["detail"]


def test_main_sweep_repeats_its_last_row(capsys):
    lines = _lines(capsys, ["--sweep", "--mb", "0.2"])
    assert [r["detail"]["threads"] for r in lines] == [1, 2, 4, 8, 16, 16]
    assert lines[-1] == lines[-2]
    assert len({r["detail"]["tokens"] for r in lines}) == 1


@pytest.mark.parametrize("argv,mode", [
    (["--mode", "device-count"], "device-count"),
    (["--host"], "host"),
], ids=["device-count", "host"])
def test_cli_bench_matches_bench_run(capsys, argv, mode):
    cli.main(["bench", "--mb", "0.3", "--device", "cpu"] + argv)
    got = json.loads(capsys.readouterr().out)
    assert got["metric"] == port_run(mode)["metric"]
    assert got["detail"]["tokens"] == port_run(mode)["detail"]["tokens"]


def test_profile_writes_a_trace(tmp_path):
    r = bench.run(mb=0.05, mode="device", passes=1, profile_dir=str(tmp_path), **CPU)
    prof = r["detail"]["profile"]
    assert r["detail"]["profile_dir"] == str(tmp_path)
    assert json.load(open(prof["trace"]))["traceEvents"]
    assert prof["wall_ms"] > 0 and prof["host_reads"] >= 1
    assert "device_ms" not in prof  # no device metric from a CPU run


def test_device_activity_merges_spans(tmp_path):
    """Busy time is the union of the device's spans; the gaps between them
    are idle."""
    path = tmp_path / "t.json"
    ev = [("kernel", 0, 10), ("kernel", 5, 10), ("gpu_memcpy", 20, 5),
          ("kernel", 400, 100), ("cpu_op", 0, 1000)]
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": c, "ts": ts, "dur": d} for c, ts, d in ev]}))
    got = bench._device_activity(str(path))
    assert got == {"device_ms": 0.12, "kernels": 3, "span_ms": 0.5,
                   "max_gap_ms": 0.375, "gaps_over_0.1ms": 1}
