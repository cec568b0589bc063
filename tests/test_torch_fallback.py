"""The long-piece fallback of the port against the JAX package's, exactly.

``piece_starts`` and the row-major ``merge_rows`` are held against their JAX
counterparts on the same numpy inputs (boolean masks and int32 ids:
tolerance 0), with the port's tables carried across from the JAX engine by
``DeviceTables.from_numpy``; the engine path against the JAX engine and the
host oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jtokkit_tpu.ops import boundaries as jax_boundaries
from jtokkit_tpu.ops import classify as jax_classify
from jtokkit_tpu.ops import merge as jax_merge
from jtokkit_tpu.utils import corpus
from jtokkit_tpu_torch.engine import device as port_device
from jtokkit_tpu_torch.ops import boundaries, classify, merge, scan

from .test_torch_engine import EDGE_CASES, _fuzz
from .test_torch_engine import engines as oracle_engines
from .test_torch_stage_a import engines

# The suite runs in several worker processes at once; torch's own thread
# pool in each of them would oversubscribe the cores.
torch.set_num_threads(1)

LONG_TEXTS = ["a" * 5000, "short text", "x " + "b" * 4500 + " y", "中文" * 300]


def _chunk(port, texts):
    (buf, doc_ends, parts, _ascii), = list(port._plan_chunks(texts))
    return buf, port._chunk_valid(doc_ends, parts, len(buf))


@pytest.mark.parametrize("kind", ["fuzz", "edge", "mixed"])
@pytest.mark.parametrize("name", ["cl100k_base", "r50k_base"])
def test_piece_starts_matches_jax(name, kind):
    """Both patterns (cl100k, and gpt2 through r50k_base)."""
    jax_eng, port = engines(name)
    if kind == "fuzz":
        texts = _fuzz(99, 300)
    elif kind == "edge":
        texts = EDGE_CASES + ["x  \n\n  y!!  ?\r\n\r\n", "a\r\n\r\n  b", "!\n\n\n a"]
    else:
        texts = corpus.generate(0.05, seed=6, flavor="mixed")
    buf, valid = _chunk(port, texts)
    want = jax_boundaries.piece_starts(
        jax_classify.classify_bytes(
            jnp.asarray(buf), jax_eng._class_table, jnp.asarray(valid)
        ),
        jax_eng.pattern,
    )
    plain, launches = scan.PLAIN_CALLS, scan.KERNEL_LAUNCHES
    info = classify.classify_bytes(
        torch.from_numpy(buf), port.tables.class_table, torch.from_numpy(valid)
    )
    got = boundaries.piece_starts(info, port.pattern)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.sum() > len(texts) // 2
    # every running maximum went through the port's one scan, independent
    # maxima sharing a call: 3 + 2 + 1 leaves for cl100k, 2 + 2 for gpt2
    assert scan.PLAIN_CALLS - plain == (3 if port.pattern == "cl100k" else 2)
    assert scan.KERNEL_LAUNCHES == launches


def test_piece_starts_scan_leaves_hold_nothing_below_minus_one(monkeypatch):
    """The leaves are positions, ordinals or -1, so the kernel's INT32_MIN
    identity for ``max`` and the reference's -1 give the same scans."""
    _jax, port = engines("cl100k_base")
    lows = []
    calls = []
    real = scan.scan_leaves

    def spy(leaves, kinds, **kw):
        lows.extend(int(x.min()) for x in leaves)
        calls.append(len(leaves))
        assert set(kinds) == {"max"} and not kw
        return real(leaves, kinds, **kw)

    monkeypatch.setattr(scan, "scan_leaves", spy)
    buf, valid = _chunk(port, _fuzz(5, 200))
    info = classify.classify_bytes(
        torch.from_numpy(buf), port.tables.class_table, torch.from_numpy(valid)
    )
    boundaries.piece_starts(info, "cl100k")
    assert calls == [3, 2, 1] and len(lows) == 6 and min(lows) == -1


def test_piece_starts_rejects_other_patterns():
    with pytest.raises(ValueError):
        boundaries.piece_starts({}, "custom")


def _piece_matrix(R, L, seed):
    """Zero-padded rows cut from a mixed corpus, lengths 0..L."""
    rng = np.random.default_rng(seed)
    text = corpus.generate(0.02, seed=seed, flavor="mixed")[0].encode()
    text += ("aaaa" * 40 + "abababab" * 20 + "中文" * 40).encode()
    starts = rng.integers(0, len(text) - L, R)
    lens = rng.integers(0, L + 1, R).astype(np.int32)
    lens[:4] = [0, 1, 2, L]
    mat = np.zeros((R, L), np.uint8)
    for r, (s, n) in enumerate(zip(starts, lens)):
        mat[r, :n] = np.frombuffer(text[s : s + n], np.uint8)
    # rows of one repeated byte: every pair ties on rank, leftmost must win
    mat[4, :] = ord("a")
    mat[5, :] = ord(" ")
    lens[4:6] = L
    return mat, lens


@pytest.mark.parametrize("name", ["cl100k_base", "p50k_base"])
@pytest.mark.parametrize("shape", [(128, 16), (128, 64)])
def test_merge_rows_matches_jax(name, shape):
    jax_eng, port = engines(name)
    mat, lens = _piece_matrix(*shape, seed=shape[1])
    ids_j, act_j = jax_merge.merge_rows(
        jnp.asarray(mat), jnp.asarray(lens), jax_eng._byte_to_id,
        jax_eng._byte_pair_id, jax_eng._cuckoo_u, jax_eng._cuckoo_v,
        jax_eng._cuckoo_id, jax_eng.packed.table_mask,
    )
    t = port.tables
    rounds = merge.MERGE_ROUNDS
    ids_t, act_t, ran = merge.merge_rows(
        torch.from_numpy(mat), torch.from_numpy(lens), t.byte_to_id,
        t.byte_pair_id, t.pair_rows_cat, t.table_mask,
    )
    assert 0 < merge.MERGE_ROUNDS - rounds == ran < shape[1]
    assert tuple(ids_t.shape) == shape and ids_t.dtype == torch.int32
    np.testing.assert_array_equal(act_t.numpy(), np.asarray(act_j))
    np.testing.assert_array_equal(
        torch.where(act_t, ids_t, -1).numpy(), np.asarray(jnp.where(act_j, ids_j, -1))
    )
    # and against the host merge, row by row
    ranks = port.oracle.ranks
    for r in (0, 1, 2, 3, 4, 5, 17, 101):
        piece = bytes(mat[r, : lens[r]])
        want = [] if not piece else (
            [ranks[piece]] if piece in ranks
            else port_device.byte_pair_merge(piece, ranks)
        )
        assert ids_t[r][act_t[r]].tolist() == want, r


@pytest.mark.parametrize("width", [16, 64, 512, 4096])
@pytest.mark.parametrize("name", ["cl100k_base", "r50k_base"])
def test_merge_rows_agrees_with_the_column_major_merge(name, width):
    """Stage B's [W, R] merge and the fallback's [R, L] merge are the same
    function of the pieces at the fallback's widths, so the fallback can run
    on Stage B's merge kernel over the transposed matrix. Past 64 lanes the
    pieces stay within 32 bytes: the plain loops run one round a merge over
    the whole matrix."""
    _jax, port = engines(name)
    mat, lens = _piece_matrix(128, min(width, 32 if width > 64 else width), seed=width)
    mat = np.pad(mat, ((0, 0), (0, width - mat.shape[1])))
    t = port.tables
    args = (t.byte_to_id, t.byte_pair_id, t.pair_rows_cat, t.table_mask)
    ids_r, act_r, _ran = merge.merge_rows(
        torch.from_numpy(mat), torch.from_numpy(lens), *args)
    ids_c, act_c, _ran = merge.merge_rows_t3(
        torch.from_numpy(mat.T.copy()), torch.from_numpy(lens), *args
    )
    assert torch.equal(act_r, act_c.T)
    assert torch.equal(torch.where(act_r, ids_r, -1), torch.where(act_c.T, ids_c.T, -1))


@pytest.mark.parametrize("name", ["cl100k_base", "r50k_base"])
def test_long_pieces_match_jax_engine_and_oracle(name):
    orc, jax_eng, port = oracle_engines(name)
    chunks, pieces = port.fallback_chunks, port.host_pieces
    runs = port.stage_a_runs
    got = port.encode_ordinary_batch(LONG_TEXTS)
    assert got == jax_eng.encode_ordinary_batch(LONG_TEXTS)
    assert got == [orc.encode_ordinary(t)[0] for t in LONG_TEXTS]
    # one chunk took the fallback; its two pieces over 4096 bytes ("a"*5000
    # and "b"*4500) merged on the host, everything else on the device
    assert port.fallback_chunks - chunks == 1
    assert port.host_pieces - pieces == 2
    assert port.stage_a_runs - runs == 1
    assert port.count_tokens_batch(LONG_TEXTS) == [len(g) for g in got]
    assert port.fallback_chunks - chunks == 2
    assert port.host_pieces - pieces == 4


def test_fallback_keeps_document_order_across_chunks():
    """A long-piece chunk between staged chunks, a document that spans both
    kinds of chunk, and empty documents inside the fallback chunk."""
    orc, jax_eng, port = oracle_engines("cl100k_base")
    para = "The quick brown fox jumps over 13 lazy dogs.\n" * 2500
    texts = [para, "", "z" * 4100 + "\n" + para, None, "tail — 中文"]
    chunks = port.fallback_chunks
    got = port.encode_ordinary_batch(texts)
    assert got == [orc.encode_ordinary(t)[0] for t in texts]
    assert got == jax_eng.encode_ordinary_batch(texts)
    assert 0 < port.fallback_chunks - chunks < 4
    assert port.count_tokens_batch(texts) == [len(g) for g in got]


def test_fallback_buckets_cover_the_largest_staged_piece():
    from jtokkit_tpu_torch.ops import stage4

    assert port_device._BUCKETS[-1] == stage4.MAX_PIECE_LEN == 4096
