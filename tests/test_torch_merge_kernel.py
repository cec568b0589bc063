"""The premise of the merge kernel (``csrc/merge.cu``), pinned on the plain
version on the CPU: the round loop of ``merge_rows_t3`` equals every piece
merged alone, so a kernel that merges each piece to its end, or to ``k``
merges, gives the loop's answer without its rounds.

- ``rounds=k`` equals each piece merged alone with at most ``k`` merges
  (``tokbench/reference/bpe.py``'s ``merge`` and its limit); with no limit,
  the oracle's ``byte_pair_merge``;
- the rounds the cold form returns are the most merges of any live piece;
- CPU tensors take the plain version and launch nothing.

The kernel itself is held against the plain version on the card by
``tests/test_torch_merge_kernel_card.py``.
"""

import numpy as np
import pytest
import torch

from jtokkit_tpu_torch import Encodings, EncodingType
from jtokkit_tpu_torch.engine.device import DeviceEngine
from jtokkit_tpu_torch.engine.oracle import byte_pair_merge
from jtokkit_tpu_torch.ops import merge
from jtokkit_tpu_torch.utils import corpus
from tokbench.reference import bpe

# The suite runs in several worker processes at once; torch's own thread
# pool in each of them would oversubscribe the cores.
torch.set_num_threads(1)

_ENGINES = {}
NAMES = {"cl100k_base": EncodingType.CL100K_BASE, "r50k_base": EncodingType.R50K_BASE}


def _engine(name):
    if name not in _ENGINES:
        enc = Encodings.new_default_encoding_registry("cpu").get_encoding(NAMES[name])
        _ENGINES[name] = DeviceEngine.from_oracle(enc.oracle, device="cpu")
    return _ENGINES[name]


def _pieces(seed, lanes, n):
    """``n`` byte strings of 0 to ``lanes`` bytes: slices of english, mixed
    and cjk text, and adversarial ones (runs of one byte, of whitespace, of
    one equal-rank pair, pieces of 0, 1 and ``lanes`` bytes)."""
    rng = np.random.default_rng(seed)
    text = b"".join(
        corpus.generate(0.004, seed=seed, flavor=f)[0].encode() for f in ("english", "mixed", "cjk"))
    out = [b"", b"x", b"a" * lanes, b" " * lanes, b"\n" * (lanes // 2) + b" " * (lanes // 2),
           (b"ab" * lanes)[:lanes], (b"  \t" * lanes)[:lanes], (b"ing" * lanes)[:lanes]]
    while len(out) < n:
        k = int(rng.integers(0, lanes + 1))
        s = int(rng.integers(0, len(text) - k))
        out.append(text[s : s + k])
    return out[:n]


def _bucket(pieces, lanes):
    mat = np.zeros((lanes, len(pieces)), np.uint8)
    for r, p in enumerate(pieces):
        mat[: len(p), r] = np.frombuffer(p, np.uint8)
    lens = np.array([len(p) for p in pieces], np.int32)
    return torch.from_numpy(mat), torch.from_numpy(lens)


def _merge(eng, mat, lens, rounds):
    t = eng.tables
    return merge.merge_rows_t3(mat, lens, t.byte_to_id, t.byte_pair_id, t.pair_rows_cat,
                               t.table_mask, rounds=rounds)


def _columns(ids, active):
    ids, active = ids.numpy(), active.numpy()
    return [ids[active[:, r], r].tolist() for r in range(ids.shape[1])]


@pytest.mark.parametrize("name", list(NAMES))
@pytest.mark.parametrize("lanes", [8, 16, 32, 64])
def test_k_rounds_equal_each_piece_merged_alone_with_k_merges(name, lanes):
    eng = _engine(name)
    ranks = eng.oracle.ranks
    pieces = _pieces(lanes, lanes, 40)
    mat, lens = _bucket(pieces, lanes)
    alone = [bpe.merge(p, ranks) if p else [] for p in pieces]
    most = max(len(p) - len(a) for p, a in zip(pieces, alone))
    for k in sorted({0, 1, 2, 3, most - 1, most, most + 2}):
        if k < 0:
            continue
        ids, active, ran = _merge(eng, mat, lens, k)
        assert ran == k
        want = [bpe.merge(p, ranks, k) if p else [] for p in pieces]
        assert _columns(ids, active) == want, k
    ids, active, ran = _merge(eng, mat, lens, None)
    assert _columns(ids, active) == alone
    assert alone == [byte_pair_merge(p, ranks) if p else [] for p in pieces]


@pytest.mark.parametrize("name", list(NAMES))
@pytest.mark.parametrize("lanes", [8, 32, 128])
def test_cold_rounds_are_the_most_merges_of_a_live_piece(name, lanes):
    """The loop's rounds are the longest piece's merges: a round merges
    once in every piece that has a pair, and a piece without one never
    changes again. Dead columns (length 0) and a bucket with no live piece
    read 0."""
    eng = _engine(name)
    ranks = eng.oracle.ranks
    pieces = _pieces(1000 + lanes, lanes, 24) + [b""] * 5
    mat, lens = _bucket(pieces, lanes)
    _ids, _active, ran = _merge(eng, mat, lens, None)
    assert ran == max(len(p) - len(bpe.merge(p, ranks)) for p in pieces if p)
    _ids, _active, counter = _merge(eng, mat, lens, merge.DEVICE)
    assert int(counter) == ran and counter.dtype == torch.int32 and counter.dim() == 0
    mat, lens = _bucket([b""] * 7, lanes)
    ids, active, ran = _merge(eng, mat, lens, None)
    assert ran == 0 and not active.any() and (ids == -1).all()


def test_cpu_tensors_take_the_plain_version():
    """The wrapper sends CPU tensors to the plain loop: the same outputs,
    no launch and nothing recorded; the CUDA entry refuses them."""
    eng = _engine("cl100k_base")
    t = eng.tables
    mat, lens = _bucket(_pieces(7, 16, 30), 16)
    launches, captured = merge.KERNEL_LAUNCHES, merge.CAPTURED_CALLS
    for rounds in (None, 2, merge.DEVICE):
        got = _merge(eng, mat, lens, rounds)
        want = merge.merge_rows_t3_plain(mat, lens, t.byte_to_id, t.byte_pair_id,
                                         t.pair_rows_cat, t.table_mask, rounds=rounds)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert int(got[2]) == int(want[2])
    assert (merge.KERNEL_LAUNCHES, merge.CAPTURED_CALLS) == (launches, captured)
    with pytest.raises(ValueError, match="CUDA"):
        merge.merge_rows_t3_cuda(mat, lens, t.byte_to_id, t.byte_pair_id,
                                 t.pair_rows_cat, t.table_mask)


def test_a_cpu_engine_runs_no_merge_kernel():
    """``merge_kernel_runs`` counts the kernel's bucket merges: none on the
    CPU, where every bucket merges in the plain loop."""
    eng = _engine("r50k_base")
    assert eng.merge_kernel_runs == 0
    docs = corpus.generate(0.02, seed=3, flavor="mixed")
    launches = merge.KERNEL_LAUNCHES
    assert eng.encode_ordinary_batch(docs) == [eng.oracle.encode_ordinary(d)[0] for d in docs]
    assert eng.merge_kernel_runs == 0 and merge.KERNEL_LAUNCHES == launches
    assert eng.merge_rounds > 0
