"""Stage A of the port against the JAX package's, exactly.

Same chunk bytes (built by the port's chunk planner from conformance rows,
edge cases and a seeded mixed corpus) go through ``jtokkit_tpu.ops.stage4``
and ``jtokkit_tpu_torch.ops.stage4``; every int32 output is compared. The
word-table hits, piece starts and lengths and the miss list are compared
directly: a wrong hash would still give the right tokens end to end.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jtokkit_tpu.engine.device import DeviceEngine as JaxEngine
from jtokkit_tpu.engine.oracle import OracleEngine as JaxOracle
from jtokkit_tpu.ops import classify as jax_classify
from jtokkit_tpu.ops import stage4 as jax_stage4
from jtokkit_tpu.utils import corpus
from jtokkit_tpu.vocab.definitions import BUILTIN_DEFINITIONS
from jtokkit_tpu.vocab.loader import load_builtin_ranks
from jtokkit_tpu_torch.engine.device import DeviceEngine
from jtokkit_tpu_torch.engine.oracle import OracleEngine
from jtokkit_tpu_torch.engine.tables import ARRAY_NAMES, DeviceTables
from jtokkit_tpu_torch.ops import classify, scan, stage4

from .conftest import load_conformance_rows

# The suite runs in several worker processes at once; torch's own thread
# pool in each of them would oversubscribe the cores.
torch.set_num_threads(1)

_ENGINES = {}


def engines(name):
    """(JAX engine, port engine on the CPU) fed identical tables."""
    if name not in _ENGINES:
        d = BUILTIN_DEFINITIONS[name]
        ranks = load_builtin_ranks(d.vocab_name)
        jax_eng = JaxEngine.from_oracle(
            JaxOracle(d.name, d.pattern, ranks, d.special_tokens)
        )
        port = DeviceEngine(
            d.name, d.pattern, jax_eng.packed,
            OracleEngine(d.name, d.pattern, ranks, d.special_tokens),
            device="cpu", chunk_bytes=1 << 17,
        )
        port.tables = DeviceTables.from_numpy(
            {k: np.asarray(getattr(jax_eng, "_" + k)) for k in ARRAY_NAMES},
            "cpu",
        )
        _ENGINES[name] = (jax_eng, port)
    return _ENGINES[name]


def _texts(kind):
    if kind == "ascii":
        rows = [t for t, _, _ in load_conformance_rows("cl100k_base")]
        texts = [t for t in rows if t.isascii()] + [
            "   \t\n  \r\n   ", "'s't're've'm'll'd 'S'T'RE", "1234567890" * 30,
            "word " * 400, "a\r\n\r\n  b", "x  \n\n  y!!  ?",
        ]
        return texts + corpus.generate(0.05, seed=3, flavor="english")
    texts = [t for t, _, _ in load_conformance_rows("cl100k_base")] + [
        "中文" * 300, "🙂" * 150, "　　a", "\xa0x y", "é'ſ 'ſ ß",
    ]
    return texts + corpus.generate(0.05, seed=4, flavor="mixed")


def _chunk(port, kind):
    (buf, doc_ends, _parts, ascii_only), = list(port._plan_chunks(_texts(kind)))
    assert ascii_only == (kind == "ascii")
    return buf, doc_ends


def _valid(buf, doc_ends):
    used = doc_ends[-1]
    valid = np.arange(len(buf)) < used
    valid[doc_ends[:-1][doc_ends[:-1] < used]] = False
    return valid


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=msg)


@pytest.mark.parametrize("kind", ["ascii", "unicode"])
def test_classify_matches_jax(kind):
    jax_eng, port = engines("cl100k_base")
    buf, doc_ends = _chunk(port, kind)
    valid = _valid(buf, doc_ends)
    if kind == "ascii":
        want = jax_stage4.classify_ascii(jnp.asarray(buf), jnp.asarray(valid))
        got = classify.classify_ascii(torch.from_numpy(buf), torch.from_numpy(valid))
    else:
        want = jax_classify.classify_bytes(
            jnp.asarray(buf), jax_eng._class_table, jnp.asarray(valid)
        )
        got = classify.classify_bytes(
            torch.from_numpy(buf), port.tables.class_table,
            torch.from_numpy(valid),
        )
    for k in ("cls", "cls_start", "is_start", "char_len", "byte"):
        if kind == "unicode" and k == "char_len":
            continue  # arbitrary at continuation bytes in both
        _eq(got[k].numpy(), want[k], k)


def test_decode_utf8_matches_jax():
    data = np.frombuffer("aé中🙂 x".encode() * 50, np.uint8)
    want = jax_classify.decode_utf8(jnp.asarray(data))
    got = classify.decode_utf8(torch.from_numpy(data.copy()))
    start = np.asarray(want[1])
    for g, w in zip(got, want):
        _eq(g.numpy()[start], np.asarray(w)[start])
    _eq(got[1].numpy(), start)


@pytest.mark.parametrize("pattern", ["gpt2", "cl100k"])
@pytest.mark.parametrize("kind", ["ascii", "unicode"])
def test_piece_starts_match_jax(pattern, kind):
    jax_eng, port = engines("cl100k_base")
    buf, doc_ends = _chunk(port, kind)
    valid = _valid(buf, doc_ends)
    ascii_chars = kind == "ascii"
    if ascii_chars:
        info_j = jax_stage4.classify_ascii(jnp.asarray(buf), jnp.asarray(valid))
        info_t = classify.classify_ascii(torch.from_numpy(buf), torch.from_numpy(valid))
    else:
        info_j = jax_classify.classify_bytes(
            jnp.asarray(buf), jax_eng._class_table, jnp.asarray(valid)
        )
        info_t = classify.classify_bytes(
            torch.from_numpy(buf), port.tables.class_table, torch.from_numpy(valid)
        )
    want_mask, want_end = jax_stage4.piece_starts_v4(
        info_j, pattern, ascii_chars=ascii_chars
    )
    calls = scan.PLAIN_CALLS
    got_mask, got_end = stage4.piece_starts_v4(
        info_t, pattern, ascii_chars=ascii_chars
    )
    assert scan.PLAIN_CALLS - calls == (3 if pattern == "cl100k" else 2)
    _eq(got_mask.numpy(), want_mask, "mask")
    _eq(got_end.numpy(), want_end, "doc_end_pos")
    assert got_mask.sum() > 100


@pytest.mark.parametrize("n,size,density", [
    (131072, 32768, 0.2),
    (131072, 4096, 0.01),
    (1024, 512, 0.9),
    (8192, 1024, 0.5),   # more set bits than slots
    (1000, 300, 0.5),    # untileable length -> nonzero path
    (8192, 8192, 0.0),   # empty mask
])
def test_masked_positions_and_rows_match_jax(n, size, density):
    rng = np.random.default_rng(n + size)
    m = rng.random(n) < density
    fields = rng.integers(-(1 << 31), 1 << 31, (n, 3), dtype=np.int64).astype(np.int32)
    want = jax_stage4.masked_positions(jnp.asarray(m), size, n)
    got = stage4.masked_positions(torch.from_numpy(m), size, n)
    _eq(got.numpy(), want)

    want_pos, want_rows = jax_stage4.masked_rows(
        jnp.asarray(m), jnp.asarray(fields), size, n
    )
    got_pos, got_rows = stage4.masked_rows(
        torch.from_numpy(m), torch.from_numpy(fields), size, n
    )
    _eq(got_pos.numpy(), want_pos)
    live = min(int(m.sum()), size)  # rows past the live prefix are junk
    _eq(got_rows.numpy()[:live], np.asarray(want_rows)[:live])


def _stage_a_both(name, buf, doc_ends, variant, divs):
    jax_eng, port = engines(name)
    table_j, meta_j = jax_eng._stage_a(variant, divs)(
        jnp.asarray(buf), jnp.asarray(doc_ends)
    )
    calls = scan.PLAIN_CALLS
    table_t, meta_t = port._stage_a(
        variant, divs, torch.from_numpy(buf), torch.from_numpy(doc_ends)
    )
    n_scans = scan.PLAIN_CALLS - calls
    return table_j, meta_j, table_t, meta_t, n_scans


def _compare_tables(table_j, meta_j, table_t, meta_t):
    _eq(meta_t.numpy(), meta_j, "meta")
    P = table_t.starts.shape[0]
    n_p = min(int(meta_j[1]), P)
    _eq(table_t.starts.numpy()[:n_p], np.asarray(table_j.starts)[:n_p], "starts")
    for k in ("lens", "hit", "group_start", "n_pieces", "bucket_counts", "overflow"):
        _eq(getattr(table_t, k).numpy(), getattr(table_j, k), k)
    n_miss = int(np.asarray(table_j.group_start)[-1])
    _eq(table_t.miss_sorted.numpy()[:n_miss],
        np.asarray(table_j.miss_sorted)[:n_miss], "miss_sorted")


@pytest.mark.parametrize("name", ["cl100k_base", "r50k_base"])
@pytest.mark.parametrize("kind", ["ascii", "unicode"])
def test_stage_a_matches_jax(name, kind):
    _jax, port = engines(name)
    buf, doc_ends = _chunk(port, kind)
    divs = (4, 32) if kind == "ascii" else (4, 8)
    table_j, meta_j, table_t, meta_t, n_scans = _stage_a_both(
        name, buf, doc_ends, kind, divs
    )
    assert n_scans == (5 if name == "cl100k_base" else 4)
    _compare_tables(table_j, meta_j, table_t, meta_t)
    hit = table_t.hit.numpy()
    assert (hit >= 0).sum() > 100 and int(meta_t[0]) == 0


def test_stage_a_capacity_overflow_bit():
    """Every piece of "a1"*80_000 is 1 byte: the primary piece table is too
    small, the roomy one is not."""
    _jax, port = engines("cl100k_base")
    (buf, doc_ends, _p, _a), = list(port._plan_chunks(["a1" * 80_000]))
    out = _stage_a_both("cl100k_base", buf, doc_ends, "ascii", (4, 32))
    _compare_tables(*out[:4])
    assert int(out[3][0]) & stage4.OVERFLOW_CAPACITY
    out = _stage_a_both("cl100k_base", buf, doc_ends, "ascii", (1, 2))
    _compare_tables(*out[:4])
    assert int(out[3][0]) == 0


def test_stage_a_piece_len_overflow_bit():
    _jax, port = engines("cl100k_base")
    (buf, doc_ends, _p, _a), = list(port._plan_chunks(["x " + "a" * 5000]))
    out = _stage_a_both("cl100k_base", buf, doc_ends, "ascii", (4, 32))
    _compare_tables(*out[:4])
    assert int(out[3][0]) & stage4.OVERFLOW_PIECE_LEN


def test_doc_token_counts_match_jax():
    rng = np.random.default_rng(5)
    P, D = 4096, 64
    n_pieces = 3000
    starts = np.sort(rng.choice(60000, n_pieces, replace=False)).astype(np.int32)
    starts = np.concatenate([starts, np.full(P - n_pieces, 65536, np.int32)])
    counts = rng.integers(0, 4, P).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    doc_ends = np.sort(rng.choice(60000, D, replace=False)).astype(np.int32)
    doc_ends[-8:] = doc_ends[-9]  # padded slots repeat the used length
    args = (offsets, np.int32(offsets[n_pieces]), starts, doc_ends, np.int32(n_pieces))
    want = jax_stage4.doc_token_counts_v4(*(jnp.asarray(a) for a in args))
    got = stage4.doc_token_counts_v4(*(torch.as_tensor(a) for a in args))
    _eq(got.numpy(), want)
