"""Stage B (the exact merge) and Stage C of the port against the JAX
package's, exactly.

The JAX engine's Stage A output for one chunk feeds both sides, so every
bucket's merge and every Stage C step sees identical inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jtokkit_tpu.ops import merge as jax_merge
from jtokkit_tpu.ops import pipeline as jax_pipeline
from jtokkit_tpu.ops import stage4 as jax_stage4
from jtokkit_tpu.utils import corpus
from jtokkit_tpu_torch.ops import merge, pipeline, stage4

from .test_torch_stage_a import engines

# The suite runs in several worker processes at once; torch's own thread
# pool in each of them would oversubscribe the cores.
torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=msg)


@pytest.mark.parametrize("name", ["cl100k_base", "p50k_base"])
def test_merge_rows_t3_matches_jax(name):
    jax_eng, port = engines(name)
    rng = np.random.default_rng(11)
    W, R = 32, 300
    text = corpus.generate(0.01, seed=2, flavor="mixed")[0].encode()
    starts = rng.integers(0, len(text) - W, R)
    mat = np.stack([np.frombuffer(text[s : s + W], np.uint8) for s in starts], 1)
    lens = rng.integers(0, W + 1, R).astype(np.int32)
    ids_j, act_j = jax_merge.merge_rows_t3(
        jnp.asarray(mat), jnp.asarray(lens), jax_eng._byte_to_id,
        jax_eng._byte_pair_id, jax_eng._pair_rows_cat, jax_eng.packed.table_mask,
    )
    t = port.tables
    rounds = merge.MERGE_ROUNDS
    ids_t, act_t, _ran = merge.merge_rows_t3(
        _t(mat), _t(lens), t.byte_to_id, t.byte_pair_id, t.pair_rows_cat,
        t.table_mask,
    )
    assert 0 < merge.MERGE_ROUNDS - rounds < W
    _eq(act_t, act_j)
    _eq(torch.where(act_t, ids_t, -1), jnp.where(act_j, ids_j, -1))


def test_pair_lookup_cat_matches_host():
    jax_eng, port = engines("cl100k_base")
    packed = jax_eng.packed
    rng = np.random.default_rng(12)
    occupied = np.flatnonzero(packed.cuckoo_u[0] >= 0)[:1000]
    u = np.concatenate([packed.cuckoo_u[0][occupied], rng.integers(-1, 100000, 1000)])
    v = np.concatenate([packed.cuckoo_v[0][occupied], rng.integers(-1, 100000, 1000)])
    got = merge.pair_lookup_cat(
        _t(u.astype(np.int32)), _t(v.astype(np.int32)),
        port.tables.pair_rows_cat, port.tables.table_mask,
    )
    want = packed.lookup_pairs(u, v)
    _eq(got, want)
    assert (want[:1000] >= 0).all()


@pytest.mark.parametrize("kind", ["ascii", "unicode"])
def test_stage_b_and_c_match_jax(kind):
    jax_eng, port = engines("cl100k_base")
    flavor = "english" if kind == "ascii" else "mixed"
    texts = corpus.generate(0.05, seed=8, flavor=flavor) + ["中文" * 300]
    if kind == "ascii":
        texts[-1] = "x" * 700 + " " + "?!" * 300
    (buf, doc_ends, _parts, _a), = list(port._plan_chunks(texts))
    divs = (4, 32) if kind == "ascii" else (4, 8)
    table, meta = jax_eng._stage_a(kind, divs)(jnp.asarray(buf), jnp.asarray(doc_ends))
    meta = np.asarray(meta)
    assert meta[0] == 0
    N = len(buf)
    tj = {k: jnp.asarray(getattr(table, k)) for k in table._fields}
    tt = {k: _t(getattr(table, k)) for k in table._fields}
    buf_t = _t(buf)
    T = port.tables

    counts_j = jax_pipeline.counts_init(tj["hit"], tj["n_pieces"])
    counts_t = pipeline.counts_init(tt["hit"], tt["n_pieces"])
    _eq(counts_t, counts_j, "counts_init")
    outs = []
    n_buckets = 0
    for b, lanes in enumerate(stage4.BUCKET_WIDTHS):
        cnt = int(meta[2 + b])
        if cnt == 0:
            continue
        n_buckets += 1
        cap = port._bucket_cap(N, lanes, cnt)
        cols_j, [(ids_j, act_j)] = jax_eng._merge_bucket_fn(lanes, cap)(
            jnp.asarray(buf), tj["starts"], tj["lens"], tj["miss_sorted"],
            tj["group_start"][b], jnp.int32(cnt), jax_eng._byte_to_id,
            jax_eng._byte_pair_seed, jax_eng._pair_rows_cat,
            jax_eng.packed.table_mask,
        )
        cols_t, ids_t, act_t, _ran = pipeline.merge_bucket_v3(
            buf_t, tt["starts"], tt["lens"], tt["miss_sorted"],
            tt["group_start"][b], cnt, T.byte_to_id, T.byte_pair_id,
            T.pair_rows_cat, T.table_mask, lanes=lanes, cap=cap,
        )
        _eq(cols_t, cols_j, f"cols {lanes}")
        _eq(act_t, act_j, f"active {lanes}")
        _eq(torch.where(act_t, ids_t, -1), jnp.where(act_j, ids_j, -1),
            f"ids {lanes}")
        counts_j = jax_pipeline.counts_add_bucket(counts_j, cols_j, act_j)
        counts_t = pipeline.counts_add_bucket(counts_t, cols_t, act_t)
        _eq(counts_t, counts_j, f"counts {lanes}")
        outs.append(((cols_j, ids_j, act_j), (cols_t, ids_t, act_t)))
    assert n_buckets >= 3

    off_j, nt_j = jax_pipeline.make_offsets(counts_j, tj["n_pieces"])
    off_t, nt_t = pipeline.make_offsets(counts_t, tt["n_pieces"])
    _eq(off_t, off_j, "offsets")
    assert int(nt_t) == int(nt_j)

    tok_j = jax_pipeline.scatter_hits(N, tj["hit"], off_j, tj["n_pieces"])
    tok_t = pipeline.scatter_hits(N, tt["hit"], off_t, tt["n_pieces"])
    _eq(tok_t, tok_j, "scatter_hits")
    for (cj, ij, aj), (ct, it, at) in outs:
        tok_j = jax_pipeline.scatter_bucket(tok_j, ij, aj, cj, off_j)
        tok_t = pipeline.scatter_bucket(tok_t, it, at, ct, off_t)
        _eq(tok_t, tok_j, "scatter_bucket")
    assert tok_t.shape == (N,)

    want = jax_stage4.doc_token_counts_v4(
        off_j, nt_j, tj["starts"], jnp.asarray(doc_ends), tj["n_pieces"]
    )
    got = stage4.doc_token_counts_v4(
        off_t, nt_t, tt["starts"], _t(doc_ends), tt["n_pieces"]
    )
    _eq(got, want, "doc counts")
