"""The merge kernel (``csrc/merge.cu``) against the plain round loop of
``merge_rows_t3``, on the card: ids, active lanes and the rounds counter
equal bit for bit (int32, tolerance 0), at every bucket width of Stage A,
under both vocabularies' tables, on random and adversarial pieces, in every
loop form; the long-piece fallback's row-major ``merge_rows`` (the kernel
over the transposed matrix) against its plain ``row_round`` loop at every
width of the fallback; then a small ring of the multilingual cell encoded on the card
and held against the benchmark's plain reference.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_merge_kernel_card.py

Without a CUDA card its tests skip.
"""

import json
import os

import numpy as np
import pytest
import torch

from jtokkit_tpu_torch import Encodings, EncodingType
from jtokkit_tpu_torch.engine import device as device_mod
from jtokkit_tpu_torch.engine.device import DeviceEngine
from jtokkit_tpu_torch.ops import merge, stage4
from jtokkit_tpu_torch.utils import corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = {"cl100k_base": EncodingType.CL100K_BASE, "r50k_base": EncodingType.R50K_BASE}
_STATE = {}


def _tables(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an H100")
    if name not in _STATE:
        enc = Encodings.new_default_encoding_registry().get_encoding(NAMES[name])
        _STATE[name] = DeviceEngine.from_oracle(enc.oracle, native_long=False).tables
    t = _STATE[name]
    return t.byte_to_id, t.byte_pair_id, t.pair_rows_cat, t.table_mask


def _text(seed):
    return b"".join(corpus.generate(0.05, seed=seed, flavor=f)[0].encode()
                    for f in ("english", "mixed", "cjk"))


def _bucket(lanes, cap, seed, live=None):
    """A [lanes, cap] bucket: random slices of english, mixed and cjk text
    of 0 to ``lanes`` bytes, adversarial pieces first (runs of one byte, of
    whitespace, of an equal-rank pair, pieces of 0, 1 and ``lanes`` bytes),
    and dead columns (length 0, zero bytes) from ``live`` on."""
    rng = np.random.default_rng(seed)
    text = _text(seed % 7)
    pieces = [b"", b"x", b"a" * lanes, b" " * lanes, (b"ab" * lanes)[:lanes],
              b"\n" * (lanes // 2) + b" " * (lanes - lanes // 2),
              (b"  \t" * lanes)[:lanes], (b"ing" * lanes)[:lanes], "中文".encode() * lanes]
    pieces = [p[:lanes] for p in pieces]
    while len(pieces) < cap:
        k = int(rng.integers(0, lanes + 1)) if rng.random() < 0.5 else lanes
        s = int(rng.integers(0, len(text) - k))
        pieces.append(text[s : s + k])
    pieces = pieces[:cap]
    live = cap if live is None else live
    mat = np.zeros((lanes, cap), np.uint8)
    lens = np.zeros(cap, np.int32)
    for r, p in enumerate(pieces[:live]):
        mat[: len(p), r] = np.frombuffer(p, np.uint8)
        lens[r] = len(p)
    return torch.from_numpy(mat).cuda(), torch.from_numpy(lens).cuda()


def _equal(got, want):
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(NAMES))
@pytest.mark.parametrize("lanes", stage4.BUCKET_WIDTHS)
def test_kernel_equals_the_plain_loop_in_every_loop_form(name, lanes):
    """Cold, ``rounds=k`` below, at and above the rounds the pieces need,
    and the device form inside a capture: ids (those left at lanes gone
    inactive too), active lanes and rounds equal the plain loop's; one
    launch a call, the captured one recorded and not launched."""
    args = _tables(name)
    cap = 45 if lanes >= 512 else 100  # not a multiple of 32
    mat, lens = _bucket(lanes, cap, seed=lanes, live=cap - 6)
    want = merge.merge_rows_t3_plain(mat, lens, *args)
    launches = merge.KERNEL_LAUNCHES
    got = merge.merge_rows_t3(mat, lens, *args)
    assert merge.KERNEL_LAUNCHES - launches == 1
    _equal(got, want)
    need = want[2]
    assert got[2] == need > 0
    for k in sorted({0, 1, 2, need // 2, need - 1, need, need + 3}):
        if k < 0:
            continue
        w = merge.merge_rows_t3_plain(mat, lens, *args, rounds=k)
        g = merge.merge_rows_t3(mat, lens, *args, rounds=k)
        assert g[2] == w[2] == k
        _equal(g, w)
    graph = torch.cuda.CUDAGraph()
    launches, captured = merge.KERNEL_LAUNCHES, merge.CAPTURED_CALLS
    with torch.cuda.graph(graph):
        ids, active, counter = merge.merge_rows_t3(mat, lens, *args, rounds=merge.DEVICE)
    assert (merge.KERNEL_LAUNCHES - launches, merge.CAPTURED_CALLS - captured) == (0, 1)
    for _ in range(2):
        ids.fill_(7)
        counter.fill_(-5)
        graph.replay()
        torch.cuda.synchronize()
        _equal((ids, active), want)
        assert int(counter) == need


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(NAMES))
def test_no_live_piece_and_single_bytes(name):
    """A bucket with no live piece (a ``count_b`` of 0) and one of
    single-byte pieces: nothing merges, the counter reads 0, ids and active
    lanes equal the plain loop's."""
    args = _tables(name)
    for lanes, live in ((8, 0), (384, 0), (16, 77)):
        mat, lens = _bucket(lanes, 77, seed=3, live=live)
        if live:
            lens = torch.clamp(lens, max=1)
        want = merge.merge_rows_t3_plain(mat, lens, *args)
        got = merge.merge_rows_t3(mat, lens, *args)
        _equal(got, want)
        assert got[2] == want[2] == 0
        _i, _a, counter = merge.merge_rows_t3(mat, lens, *args, rounds=merge.DEVICE)
        assert int(counter) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(NAMES))
@pytest.mark.parametrize("width", device_mod._BUCKETS)
def test_fallback_rows_equal_the_plain_row_loop(name, width):
    """The fallback's ``merge_rows`` on the card, one kernel launch over the
    transposed matrix, equals the plain ``row_round`` loop: active lanes and
    rounds exactly, ids where active; in the cold, device and fixed
    forms."""
    args = _tables(name)
    mat_t, lens = _bucket(width, device_mod._MIN_ROWS, seed=width + 1,
                          live=device_mod._MIN_ROWS - 6)
    mat = mat_t.T.contiguous()

    def same(got, want):
        assert torch.equal(got[1], want[1])
        assert torch.equal(torch.where(got[1], got[0], -1), torch.where(want[1], want[0], -1))

    want = merge.merge_rows_plain(mat, lens, *args)
    launches = merge.KERNEL_LAUNCHES
    got = merge.merge_rows(mat, lens, *args)
    assert merge.KERNEL_LAUNCHES - launches == 1
    same(got, want)
    assert got[2] == want[2] > 0
    ids, active, counter = merge.merge_rows(mat, lens, *args, rounds=merge.DEVICE)
    same((ids, active), want)
    assert int(counter) == want[2]
    k = want[2] // 2
    got = merge.merge_rows(mat, lens, *args, rounds=k)
    want = merge.merge_rows_plain(mat, lens, *args, rounds=k)
    same(got, want)
    assert got[2] == want[2] == k


@pytest.mark.gpu
def test_a_rank_beyond_the_key_raises():
    """A table whose ranks do not fit the packed key is refused before any
    launch."""
    byte_to_id, byte_pair_id, rows, mask = _tables("r50k_base")
    big = byte_pair_id.clone()
    big[5] = merge.KEY_RANK_LIMIT
    mat, lens = _bucket(8, 40, seed=1)
    launches = merge.KERNEL_LAUNCHES
    with pytest.raises(ValueError, match="key"):
        merge.merge_rows_t3(mat, lens, byte_to_id, big, rows, mask)
    assert merge.KERNEL_LAUNCHES == launches


@pytest.mark.gpu
def test_a_culturax_ring_on_the_card_equals_the_reference():
    """A small ring of the multilingual cell's mix (English, accented Latin,
    Cyrillic, Chinese web pages), encoded on the card with every chunk's
    pieces merged by the kernel (native routing off), equals the plain
    reference of ``tokbench/reference/`` document by document; the engine
    counts the kernel's bucket merges."""
    if not torch.cuda.is_available():
        pytest.skip("needs an H100")
    from tokbench import ring as ring_mod
    from tokbench.reference.bpe import Reference

    with open(os.path.join(REPO, "tokbench", "configs", "cl100k-culturax.json")) as f:
        config = json.load(f)
    with open(os.path.join(REPO, "tokbench", "traffic", "culturax-encode.json")) as f:
        traffic = json.load(f)
    traffic.update(batch_bytes=1 << 19, ring_min_batches=2, ring_min_bytes=1 << 20)
    ring = ring_mod.build_ring(config, traffic, seed=2**31 + 91)
    ref = Reference(os.path.join(REPO, config["vocab_file"]), config["pattern"])
    enc = Encodings.new_default_encoding_registry().get_encoding(EncodingType.CL100K_BASE)
    engine = DeviceEngine.from_oracle(enc.oracle, native_long=False)
    for batch in ring.batches[:2]:
        runs = engine.merge_kernel_runs
        got = engine.encode_ordinary_batch_arrays(batch)
        assert engine.merge_kernel_runs > runs
        for doc, ids in zip(batch, got):
            assert ids.tolist() == ref.encode(doc)
    assert engine.merge_rounds > 0
