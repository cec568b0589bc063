"""The port's multi-leaf scan against the JAX package's.

On the CPU ``jtokkit_tpu_torch.ops.scan.scan_leaves`` takes its plain
PyTorch version; it is held exactly (int32) against the Pallas kernel run in
interpret mode and against ``jax.lax.associative_scan``. The CUDA kernel is
held against the plain version on the card in ``test_torch_scan_card.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jtokkit_tpu.ops import pallas_scan
from jtokkit_tpu_torch.ops import scan

# The suite runs in several worker processes at once; torch's own thread
# pool in each of them would oversubscribe the cores.
torch.set_num_threads(1)


def _leaves(n, seed):
    """Boundary-scan-like leaves: sparse set positions (else -1) and a
    dense 0/1 add leaf."""
    rng = np.random.default_rng(seed)
    idx = np.arange(n, dtype=np.int32)
    return [
        np.where(rng.random(n) < 0.1, idx * 2 + (idx % 2), -1).astype(np.int32),
        np.where(rng.random(n) < 0.01, rng.integers(0, 7, n), -1).astype(np.int32),
        rng.integers(0, 2, n).astype(np.int32),
    ]


def _associative(leaves, kinds, reverse):
    def comb(a, b):
        return tuple(
            pallas_scan._combine(k, x, y) for k, x, y in zip(kinds, a, b)
        )

    out = jax.lax.associative_scan(
        comb, tuple(jnp.asarray(x) for x in leaves), reverse=reverse
    )
    return [np.asarray(x) for x in out]


def _port(leaves, kinds, reverse):
    out = scan.scan_leaves(
        [torch.from_numpy(x) for x in leaves], kinds, reverse=reverse
    )
    return [x.numpy() for x in out]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", [1024, 32768, 131072])
def test_scan_matches_pallas_interpret(n, reverse):
    leaves = _leaves(n, n + reverse)
    kinds = ["max", "last", "add"]
    want = pallas_scan.scan_leaves(
        [jnp.asarray(x) for x in leaves], kinds,
        reverse=reverse, enabled=True, interpret=True,
    )
    for k, g, w in zip(kinds, _port(leaves, kinds, reverse), want):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=k)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", [1, 2, 127, 129, 1000, 4097])
def test_scan_ragged_matches_associative_scan(n, reverse):
    leaves = _leaves(n, 7 * n + reverse)
    for kinds in (["max", "last", "add"], ["last", "max", "max"],
                  ["add", "add", "last"]):
        want = _associative(leaves, kinds, reverse)
        for k, g, w in zip(kinds, _port(leaves, kinds, reverse), want):
            np.testing.assert_array_equal(g, w, err_msg=f"{kinds} {k}")


def test_scan_four_leaves_and_counters():
    leaves = _leaves(5000, 3) + [np.full(5000, -1, np.int32)]
    kinds = ["max", "last", "add", "last"]
    launches, plain = scan.KERNEL_LAUNCHES, scan.PLAIN_CALLS
    got = _port(leaves, kinds, True)
    want = _associative(leaves, kinds, True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert scan.PLAIN_CALLS == plain + 1
    assert scan.KERNEL_LAUNCHES == launches


@pytest.mark.parametrize("leaves,kinds,err", [
    ([torch.zeros(8, dtype=torch.int64)], ["max"], TypeError),
    ([torch.zeros(8, dtype=torch.int32)] * 5, ["max"] * 5, ValueError),
    ([torch.zeros(8, dtype=torch.int32)], ["min"], ValueError),
    ([torch.zeros(8, dtype=torch.int32), torch.zeros(9, dtype=torch.int32)],
     ["max", "max"], TypeError),
])
def test_scan_rejects_what_the_kernel_does_not_take(leaves, kinds, err):
    with pytest.raises(err):
        scan.scan_leaves(leaves, kinds)


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError):
        scan.scan_leaves_cuda([torch.zeros(8, dtype=torch.int32)], ["max"])



# ---- what the CUDA wrapper decides in Python (no card, no launch) ---------


def _source_constant(name):
    import os
    import re

    path = os.path.join(os.path.dirname(scan.__file__), "..", "csrc", "scan.cu")
    with open(path) as f:
        m = re.search(rf"constexpr \w+ {name} = ([^;]+);", f.read())
    return m.group(1)


def test_python_constants_match_the_source():
    tile = int(_source_constant("kThreads")) * int(_source_constant("kItems"))
    assert tile == scan.TILE
    assert int(_source_constant("kHeaderWords")) == scan.HEADER_WORDS
    assert _source_constant("kEpochMask") == f"(1u << {scan.EPOCH_BITS}) - 1u"
    assert int(_source_constant("kMaxLeaves")) == scan.MAX_LEAVES
    assert scan.CLEAR_EVERY < 1 << scan.EPOCH_BITS


@pytest.mark.parametrize("n_leaves,n,tiles", [
    (1, 1, 1), (1, scan.TILE, 1), (1, scan.TILE + 1, 2), (3, 1 << 20, 128),
    (4, 1 << 24, 2048), (2, (1 << 15) + 5, 5),
])
def test_scratch_words_is_header_plus_one_word_per_tile_and_leaf(n_leaves, n, tiles):
    assert scan.scratch_words(n_leaves, n) == scan.HEADER_WORDS + n_leaves * tiles


def test_scratch_is_zeroed_kept_and_grown(monkeypatch):
    monkeypatch.setattr(scan, "SCRATCH", {})
    cpu = torch.device("cpu")
    small = scan.scratch_for(cpu, 0, 111, scan.scratch_words(3, 1 << 20))
    assert small.dtype == torch.int64 and small.numel() == scan.MIN_SCRATCH_WORDS
    assert int(small.abs().sum()) == 0
    small[:] = 7  # what calls leave behind
    # the next call, and a smaller one, get the same words, untouched
    assert scan.scratch_for(cpu, 0, 111, scan.scratch_words(3, 1 << 20)) is small
    assert scan.scratch_for(cpu, 0, 111, scan.scratch_words(1, 1)) is small
    assert int(small.min()) == 7
    # a call that needs more gets a new zeroed scratch, a power of two long
    need = scan.scratch_words(4, 1 << 26)
    big = scan.scratch_for(cpu, 0, 111, need)
    assert big is not small and big.numel() >= need
    assert big.numel() & (big.numel() - 1) == 0 and int(big.abs().sum()) == 0
    assert scan.scratch_for(cpu, 0, 111, scan.scratch_words(1, 1)) is big
    assert len(scan.SCRATCH) == 1


def test_scratch_is_keyed_by_device_and_stream(monkeypatch):
    monkeypatch.setattr(scan, "SCRATCH", {})
    cpu = torch.device("cpu")
    words = [scan.scratch_for(cpu, d, s, 10) for d, s in ((0, 111), (0, 222), (1, 111))]
    assert len({w.data_ptr() for w in words}) == 3
    assert set(scan.SCRATCH) == {(0, 111), (0, 222), (1, 111)}
    assert scan.scratch_for(cpu, 0, 222, 10) is words[1]


def test_scratch_status_words_are_cleared_before_the_epoch_comes_round(monkeypatch):
    monkeypatch.setattr(scan, "SCRATCH", {})
    monkeypatch.setattr(scan, "CLEAR_EVERY", 3)
    cpu = torch.device("cpu")
    words = scan.scratch_for(cpu, 0, 5, 10)
    words[:] = 9
    for _ in range(2):  # calls 2 and 3: nothing is cleared
        assert scan.scratch_for(cpu, 0, 5, 10) is words
    assert int(words.min()) == 9
    # call 4 would meet status words of the epoch it is about to reuse
    assert scan.scratch_for(cpu, 0, 5, 10) is words
    assert words[: scan.HEADER_WORDS].tolist() == [9] * scan.HEADER_WORDS
    assert int(words[scan.HEADER_WORDS:].abs().sum()) == 0
    assert scan.SCRATCH[(0, 5)].calls == 1


@pytest.mark.parametrize("n", [0, 1, 5, 127, 4097, 1 << 15])
def test_output_rows_start_on_16_byte_boundaries(n):
    rows = scan.empty_rows(3, n, torch.device("cpu"))
    assert len(rows) == 3
    for r in rows:
        assert r.shape == (n,) and r.dtype == torch.int32 and r.is_contiguous()
        assert r.data_ptr() % 16 == 0


@pytest.mark.parametrize("reverse", [False, True])
def test_leaves_at_an_odd_offset_are_taken(reverse):
    """A view that is not 16-byte aligned is scanned like any other (the
    kernel falls back to 4-byte loads; the plain version does not care)."""
    base = _leaves(1001, 11)
    views = [torch.from_numpy(x)[1:] for x in base]
    assert any(v.data_ptr() % 16 for v in views)
    kinds = ["max", "last", "add"]
    got = scan.scan_leaves(views, kinds, reverse=reverse)
    want = _associative([x[1:] for x in base], kinds, reverse)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_tuning_script_rewrites_the_shipped_source(monkeypatch):
    """``scripts/tune_scan.py`` builds its variants by replacing text of
    ``csrc/scan.cu``: every replacement still finds its text, and the script
    raises without a card."""
    from jtokkit_tpu_torch.scripts import tune_scan

    with open(scan.LIBRARY.source) as f:
        base = f.read()
    for spec in tune_scan.DEFAULT:
        parts = spec.split(",")
        text = tune_scan.variant_source(base, int(parts[0]), int(parts[1]), parts[2], parts[3:])
        assert f"kThreads = {parts[0]};" in text and f"kItems = {parts[1]};" in text
        assert ("ld.acquire.gpu" in text) == (parts[2] == "acqrel")
        assert ("look_back<K>(status" in text) == ("nolook" not in parts)
    assert tune_scan.variant_source(base, 256, 32, "relaxed") == base
    with pytest.raises(ValueError):
        tune_scan.variant_source(base, 256, 32, "seq_cst")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tune_scan.main(["256,32,relaxed"])
