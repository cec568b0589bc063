"""The un-planned path's graph cache and the merges' device form, against the
JAX package and the host oracle.

On the CPU the device form (``merge.DEVICE``; on the card one merge kernel
launch that leaves its round counter unread) is the plain loop that reads
its exit test back after every round and returns its count as a tensor, and a
cached unit of ``DeviceEngine(cold_cache=True)`` runs its recorded body
eagerly on its static inputs: the bookkeeping of the cache (keys, static
inputs, copies of the outputs, round counters read with the last read) is
the one the card runs. Inputs come from the seeded corpus and numpy; port
engines use ``device="cpu"`` and ``chunk_bytes=1<<17``. Every comparison is
exact (integer ids: tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from jtokkit_tpu.ops import merge as jax_merge
from jtokkit_tpu.ops import merge_exact as jax_exact
from jtokkit_tpu.utils import corpus
from jtokkit_tpu_torch import Encodings
from jtokkit_tpu_torch.engine.device import DeviceEngine
from jtokkit_tpu_torch.ops import merge, pipeline, stage4
from jtokkit_tpu_torch.parallel import mesh
from jtokkit_tpu_torch.parallel.sharded import ShardedTokenizer

from .conftest import load_conformance_rows
from .test_torch_engine import engines

# The suite runs in several worker processes at once; torch's own thread
# pool in each of them would oversubscribe the cores.
torch.set_num_threads(1)

ENCODINGS = ["r50k_base", "p50k_base", "p50k_edit", "cl100k_base"]


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=msg)


def _flavor_texts(flavor: str, seed: int):
    """About 40 KB of seeded text. CJK runs are cut to 20 characters: the
    plain loop runs one round a byte of the longest piece, and a 600-byte
    run would take minutes on the CPU."""
    if flavor != "cjk":
        return corpus.generate(0.04, seed=seed, flavor=flavor)
    out = []
    for d in corpus.generate(0.04, seed=seed, flavor=flavor):
        out.append(" ".join(d[i : i + 20] for i in range(0, len(d), 20)))
    return out


def _chunk_table(port, flavor, seed):
    """(buf, piece table, meta) of the first chunk of the flavor's text,
    Stage A run by the port on the CPU."""
    buf, doc_ends, _parts, ascii_only = next(port._plan_chunks(_flavor_texts(flavor, seed)))
    variant = "ascii" if ascii_only else "unicode"
    table, meta = port._stage_a(variant, (4, 32) if ascii_only else (4, 8),
                                _t(buf), _t(doc_ends))
    return _t(buf), table, meta.numpy()


@pytest.mark.parametrize("flavor", ["english", "mixed", "cjk"])
def test_device_loop_buckets_match_jax(flavor):
    """Every bucket of a chunk: the device form (its plain version here) with
    ``count_b`` and ``group_start_b`` as 0-d tensors sliced from the piece
    table equals the JAX merge (``merge_bucket_v3``; at 64 lanes and more
    also the wide ``merge_bucket_exact``, piece by piece) and the port's cold
    form with plain ints; the device counter equals the cold form's
    rounds."""
    _orc, jax_eng, port = engines("cl100k_base")
    T = port.tables
    buf, tab, meta = _chunk_table(port, flavor, seed=3)
    assert meta[0] == 0
    jt = {k: jnp.asarray(getattr(tab, k).numpy()) for k in tab._fields}
    buckets = wide_buckets = 0
    for b, lanes in enumerate(stage4.BUCKET_WIDTHS):
        cnt = int(meta[2 + b])
        if cnt == 0:
            continue
        buckets += 1
        cap = port._bucket_cap(buf.shape[0], lanes, cnt)
        args = (buf, tab.starts, tab.lens, tab.miss_sorted)
        live = (tab.group_start[b], tab.bucket_counts[b])
        assert live[0].dim() == 0 and live[1].dim() == 0
        cols_j, [(ids_j, act_j)] = jax_eng._merge_bucket_fn(lanes, cap)(
            jnp.asarray(buf.numpy()), jt["starts"], jt["lens"], jt["miss_sorted"],
            jt["group_start"][b], jnp.int32(cnt), jax_eng._byte_to_id,
            jax_eng._byte_pair_seed, jax_eng._pair_rows_cat, jax_eng.packed.table_mask,
        )
        narrow_args = (T.byte_to_id, T.byte_pair_id, T.pair_rows_cat, T.table_mask)
        cols, ids, act, counter = pipeline.merge_bucket_v3(
            *args, *live, *narrow_args, lanes=lanes, cap=cap, rounds=merge.DEVICE)
        cols_c, ids_c, act_c, ran = pipeline.merge_bucket_v3(
            *args, int(tab.group_start[b]), cnt, *narrow_args, lanes=lanes, cap=cap)
        assert counter.dtype == torch.int32 and counter.dim() == 0
        assert int(counter) == ran > 0, (lanes, int(counter), ran)
        for c, i, a in ((cols, ids, act), (cols_c, ids_c, act_c)):
            _eq(c, cols_j, f"cols {lanes}")
            _eq(a, act_j, f"active {lanes}")
            _eq(torch.where(a, i, -1), jnp.where(act_j, ids_j, -1), f"ids {lanes}")
        if lanes < 64:
            continue
        wide_buckets += 1
        cols_j, outs_j = jax_exact.merge_bucket_exact(
            jnp.asarray(buf.numpy()), jt["starts"], jt["lens"], jt["miss_sorted"],
            jt["group_start"][b], jnp.int32(cnt), jax_eng._byte_to_id,
            jax_eng._byte_pair_seed, jax_eng._pair_rows_cat, jax_eng.packed.table_mask,
            lanes=lanes, cap=cap,
        )
        _eq(cols, cols_j)
        got = {r: ids[act[:, r], r].tolist() for r in range(cnt)}
        emitted = {}
        for ids_j, act_j in outs_j:
            ids_j, act_j = np.asarray(ids_j), np.asarray(act_j)
            for r in np.flatnonzero(act_j[:, :cnt].any(axis=0)):
                emitted[r] = ids_j[act_j[:, r], r].tolist()
        assert emitted == got, f"wide {lanes}"
    assert buckets >= 2
    assert wide_buckets > 0 or flavor == "english"


@pytest.mark.parametrize("shape", [(128, 16), (128, 64)])
def test_device_loop_merge_rows_matches_jax(shape):
    """The long-piece fallback's row-major merge in the device form (its
    plain version here): ids and active lanes equal the JAX ``merge_rows``,
    its counter the cold form's rounds, and the fixed form at that count the
    same state."""
    _orc, jax_eng, port = engines("cl100k_base")
    R, L = shape
    rng = np.random.default_rng(L)
    text = "".join(_flavor_texts("mixed", seed=4)).encode()
    lens = rng.integers(0, L + 1, R).astype(np.int32)
    starts = rng.integers(0, len(text) - L, R)
    mat = np.zeros((R, L), np.uint8)
    for r in range(R):
        mat[r, : lens[r]] = np.frombuffer(text[starts[r] : starts[r] + lens[r]], np.uint8)
    ids_j, act_j = jax_merge.merge_rows(
        jnp.asarray(mat), jnp.asarray(lens), jax_eng._byte_to_id,
        jax_eng._byte_pair_id, jax_eng._cuckoo_u, jax_eng._cuckoo_v,
        jax_eng._cuckoo_id, jax_eng.packed.table_mask,
    )
    T = port.tables
    args = (_t(mat), _t(lens), T.byte_to_id, T.byte_pair_id, T.pair_rows_cat, T.table_mask)
    ids, act, counter = merge.merge_rows(*args, rounds=merge.DEVICE)
    _ids, _act, ran = merge.merge_rows(*args)
    ids_k, act_k, ran_k = merge.merge_rows(*args, rounds=int(counter))
    assert int(counter) == ran == ran_k > 0
    for i, a in ((ids, act), (ids_k, act_k)):
        _eq(a, act_j)
        _eq(torch.where(a, i, -1), jnp.where(act_j, ids_j, -1))


def test_device_loop_plain_version_reads_every_test():
    """On the CPU the device form is the cold loop, for Stage B's bucket and
    for the fallback's rows: one exit test read back per round and a last
    one; the rounds come back as a 0-d int32 tensor and are not added to
    ``MERGE_ROUNDS`` (whoever reads the counter adds them)."""
    _orc, _jax, port = engines("cl100k_base")
    T = port.tables
    buf, tab, meta = _chunk_table(port, "english", seed=5)
    b = int(np.flatnonzero(meta[2:])[0])
    lanes = stage4.BUCKET_WIDTHS[b]
    cap = port._bucket_cap(buf.shape[0], lanes, int(meta[2 + b]))
    tests, rounds = merge.EXIT_TESTS, merge.MERGE_ROUNDS
    _c, _i, _a, counter = pipeline.merge_bucket_v3(
        buf, tab.starts, tab.lens, tab.miss_sorted, tab.group_start[b],
        tab.bucket_counts[b], T.byte_to_id, T.byte_pair_id, T.pair_rows_cat,
        T.table_mask, lanes=lanes, cap=cap, rounds=merge.DEVICE)
    assert counter.dtype == torch.int32 and counter.dim() == 0
    assert merge.EXIT_TESTS - tests == int(counter) + 1
    assert merge.MERGE_ROUNDS == rounds
    tests = merge.EXIT_TESTS
    mat = torch.full((128, 16), ord("a"), dtype=torch.uint8)
    lens = torch.full((128,), 16, dtype=torch.int32)
    _i, _a, counter = merge.merge_rows(mat, lens, T.byte_to_id, T.byte_pair_id,
                                       T.pair_rows_cat, T.table_mask, rounds=merge.DEVICE)
    assert counter.dtype == torch.int32 and counter.dim() == 0 and int(counter) > 0
    assert merge.EXIT_TESTS - tests == int(counter) + 1
    assert merge.MERGE_ROUNDS == rounds


def _cached_engine(**kw):
    orc, _jax, port = engines("cl100k_base")
    return orc, DeviceEngine.from_oracle(
        port.oracle, device="cpu", chunk_bytes=1 << 17, native_long=False,
        cold_cache=True, **kw)


def _miss_words(seed: int, n: int) -> str:
    """``n`` random 4-7 letter strings: nearly all miss the word table and
    fall into the 8-lane bucket."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("bcdfghjklmnpqrstvwxz"))
    return " ".join("".join(rng.choice(letters, rng.integers(4, 8))) for _ in range(n))


def test_cache_signature_leaves_out_the_live_counts():
    """Two un-planned calls over different texts of one shape (same flat
    size, document slots and bucket capacities, other live counts) share
    one Stages B-C unit and one Stage A unit; a count that moves a bucket to
    another capacity makes another unit. Ids equal the oracle's."""
    orc, eng = _cached_engine()
    filler = "the cat sat on the mat. " * 2500  # word-table hits: no bucket
    a = [filler, _miss_words(1, 150)]
    b = [filler, _miss_words(2, 260)]
    c = [filler, _miss_words(3, 3000)]
    caps = []
    for texts in (a, b, c):
        assert eng.encode_ordinary_batch(texts) == [orc.encode_ordinary(t)[0] for t in texts]
        keys = list(eng._cold["stages_b_c"])
        caps.append(keys[-1])
    assert len(eng._cold["stage_a"]) == 1
    sig_a, sig_b, sig_c = caps
    assert sig_a == sig_b, "the live counts entered the signature"
    assert len(eng._cold["stages_b_c"]) == 2 and sig_c != sig_a
    assert sig_a[:4] == sig_c[:4] and sig_a[-1] is True
    (b0, lanes0, cap_a), *_ = sig_a[4]
    (b0c, _l, cap_c), *_ = sig_c[4]
    assert (b0, lanes0) == (b0c, 8) and cap_c > cap_a
    stats = eng.cold_cache_stats()
    assert stats["units"] == 3 and stats["captures"] == 0  # no graphs on the CPU


@pytest.mark.parametrize("name", ENCODINGS)
def test_cold_cache_matches_jax_and_oracle_on_conformance(name):
    """The four conformance CSVs through the un-planned path from the cache:
    the registry's encode_ordinary_batch, encode_batch and
    count_tokens_batch (its engine with the cache switched on) and a
    DeviceEngine of 128 KiB chunks, against the CSV, the JAX engine and the
    oracle."""
    _orc, jax_eng, _port = engines(name)
    rows = load_conformance_rows(name)
    texts = [r[0] for r in rows]
    want = [list(r[1]) for r in rows]
    enc = Encodings.new_default_encoding_registry(device="cpu").get_encoding(name)
    reg_engine = enc.device_engine()
    reg_engine.cold_cache = True
    assert jax_eng.encode_ordinary_batch(texts) == want
    assert enc.encode_ordinary_batch(texts) == want
    assert enc.count_tokens_batch(texts) == [len(w) for w in want]
    assert [enc.oracle.encode_ordinary(t)[0] for t in texts] == want
    assert reg_engine.cold_cache_stats()["units"] >= 2
    eng = DeviceEngine.from_oracle(enc.oracle, device="cpu", chunk_bytes=1 << 17,
                                   cold_cache=True)
    assert eng.encode_ordinary_batch(texts) == want
    assert eng.count_tokens_batch(texts) == [len(w) for w in want]
    assert [a.tolist() for a in eng.encode_ordinary_batch_arrays(texts)] == want


WIDE_DOCS = [
    "今日はよい天気です" "東京都港区" * 12,
    "." * 200 + "!" * 90,
    "mixed 短い run with spaces and 漢字" * 6,
    "plain english words stay on the narrow engine.",
]


@pytest.mark.parametrize("wide", [False, True])
def test_plan_first_pass_fills_rounds_from_the_counters(wide):
    """A plan's first pass through the cache (count, then encode on another
    plan) leaves per-bucket rounds equal to an eager engine's read-per-round
    pass; ``MERGE_ROUNDS`` gains them at the pass's last read; the warmed
    passes after it agree with the oracle. ``wide`` adds the documents that
    the JAX package routes to its wide-bucket merge (buckets of 64 lanes and
    more)."""
    orc, eng = _cached_engine()
    eager = DeviceEngine.from_oracle(eng.oracle, device="cpu", chunk_bytes=1 << 17,
                                     native_long=False, cold_cache=False)
    docs = (WIDE_DOCS if wide else []) + [_flavor_texts("mixed", seed=6)[0][:6000]]
    want = [orc.encode_ordinary(t)[0] for t in docs]
    plans = {}
    for e in (eng, eager):
        p = plans[e.cold_cache] = e.preload_corpus(docs), e.preload_corpus(docs)
        rounds = merge.MERGE_ROUNDS
        assert e.count_tokens_corpus(None, plan=p[0]) == sum(map(len, want))
        ran = [r for c in p[0].chunk_cache for r in c["rounds"]]
        assert merge.MERGE_ROUNDS - rounds == sum(ran) > 0
        assert [a.tolist() for a in e.encode_ordinary_batch_arrays(None, plan=p[1])] == want
    cached, ref = plans[True], plans[False]
    for k in (0, 1):
        assert [c["rounds"] for c in cached[k].chunk_cache] == \
            [c["rounds"] for c in ref[k].chunk_cache]
        assert [c["caps"] for c in cached[k].chunk_cache] == \
            [c["caps"] for c in ref[k].chunk_cache]
    if wide:
        assert any(lanes >= 64 for c in cached[0].chunk_cache
                   for _b, lanes, _cap, _n in c["caps"])
    for _ in range(2):
        assert eng.count_tokens_corpus(None, plan=cached[0]) == sum(map(len, want))
        assert [a.tolist() for a in eng.encode_ordinary_batch_arrays(None, plan=cached[1])] \
            == want


def test_read_settles_pending_rounds_once():
    """``_read(t, pending)`` returns ``t``'s values, fills each pending
    entry's rounds (one counter a bucket) from the counters fetched in the
    same read and empties the list; one host read in all."""
    _orc, eng = _cached_engine()
    entry = {"kind": "ok", "caps": [(0, 8, 512, 3), (1, 16, 512, 1)], "rounds": None}
    pending = [(entry, torch.tensor([4, 7], dtype=torch.int32))]
    reads, rounds = eng.host_reads, merge.MERGE_ROUNDS
    got = eng._read(torch.tensor([[5, 6], [7, 8]], dtype=torch.int64), pending)
    _eq(got, [[5, 6], [7, 8]])
    assert got.dtype == np.int64 and pending == []
    assert entry["rounds"] == [4, 7]
    assert eng.host_reads - reads == 1 and merge.MERGE_ROUNDS - rounds == 11


def test_cache_drops_the_least_recently_used_unit():
    """Past ``COLD_CACHE_MAX`` units the least recently used one goes; the
    calls stay right."""
    orc, eng = _cached_engine()
    eng.COLD_CACHE_MAX = 2
    shapes = [["short text number one"], ["x" * 9000 + " tail"], ["word " * 30000]]
    for texts in shapes + shapes[:1]:
        assert eng.encode_ordinary_batch(texts) == [orc.encode_ordinary(t)[0] for t in texts]
        assert len(eng._cold["stage_a"]) <= 2
    keys = [k[2] for k in eng._cold["stage_a"]]
    assert keys == [262144, 8192], keys  # the 8 KB chunk came back last


def test_fallback_merge_from_the_cache(monkeypatch):
    """A chunk with a piece over 4096 bytes on the engine with the cache on:
    each of the fallback's buckets is one ``merge_rows`` call in the device
    form (on the card one kernel launch), read back with its counter in ONE
    read beside the plain loop's exit tests, and the cache keeps no unit
    for it. The ids equal the oracle's and an eager engine's, with equal
    merge rounds."""
    orc, eng = _cached_engine()
    eager = DeviceEngine.from_oracle(eng.oracle, device="cpu", chunk_bytes=1 << 17,
                                     native_long=False, cold_cache=False)
    docs = ["a" * 5000 + " end", "intro " + "中文字" * 12 + " words and more words"]
    want = [orc.encode_ordinary(t)[0] for t in docs]
    calls, buckets = [], []
    real_rows, real_flat = merge.merge_rows, eng._merge_flat

    def merge_rows(mat, *args, **kw):
        calls.append((tuple(mat.shape), kw.get("rounds")))
        return real_rows(mat, *args, **kw)

    def merge_flat(mat, blens, n):
        made, reads, tests = len(calls), eng.host_reads, merge.EXIT_TESTS
        out = real_flat(mat, blens, n)
        buckets.append((mat.shape, len(calls) - made,
                        eng.host_reads - reads - (merge.EXIT_TESTS - tests)))
        return out

    monkeypatch.setattr(merge, "merge_rows", merge_rows)
    monkeypatch.setattr(eng, "_merge_flat", merge_flat)
    got = []
    for e in (eng, eager):
        rounds = merge.MERGE_ROUNDS
        assert e.encode_ordinary_batch(docs) == want
        got.append(merge.MERGE_ROUNDS - rounds)
    assert got[0] == got[1] > 0
    assert eng.fallback_chunks == 1 and eng.host_pieces == 1
    assert [b[1:] for b in buckets] == [(1, 1)] * len(buckets)
    assert {shape[1] for shape, _c, _r in buckets} >= {16}
    assert all(shape[0] >= 128 for shape, _c, _r in buckets)
    assert calls[: len(buckets)] == [(shape, merge.DEVICE) for shape, _c, _r in buckets]
    assert set(eng._cold) == {"stage_a", "stages_b_c"}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """A world-1 gloo group in this process for the sharded test."""
    store = tmp_path_factory.mktemp("store") / "rendezvous"
    mesh.initialize_distributed(f"file://{store}", 1, 0, device="cpu")
    yield mesh.data_group()
    dist.destroy_process_group()


def test_sharded_cold_passes_take_the_cache(group):
    """The ShardedTokenizer's cold count reads the round counters with its
    all-reduced total, and its cold encode with the engine's read: the plan's
    rounds equal an eager engine's and the totals the oracle's."""
    orc, eng = _cached_engine()
    tok = ShardedTokenizer(eng, group=group)
    docs = _flavor_texts("english", seed=7) + WIDE_DOCS
    want = [orc.encode_ordinary(t)[0] for t in docs]
    eager = DeviceEngine.from_oracle(eng.oracle, device="cpu", chunk_bytes=1 << 17,
                                     native_long=False, cold_cache=False)
    ref = eager.preload_corpus(docs)
    eager.count_tokens_corpus(None, plan=ref)
    plan = tok.preload_corpus(docs)
    reads, tests = eng.host_reads, merge.EXIT_TESTS
    assert tok.count_tokens_corpus(None, plan=plan) == sum(map(len, want))
    # the metas, the total with the rounds (and the plain loops' exit tests)
    assert eng.host_reads - reads - (merge.EXIT_TESTS - tests) == 2
    assert [c.get("rounds") for c in plan.plan.chunk_cache] == \
        [c.get("rounds") for c in ref.chunk_cache]
    fresh = tok.preload_corpus(docs)
    assert tok.encode_ordinary_batch_arrays(None, plan=fresh) is not None
    assert [c.get("rounds") for c in fresh.plan.chunk_cache] == \
        [c.get("rounds") for c in ref.chunk_cache]
    assert [a.tolist() for a in tok.encode_ordinary_batch_arrays(None, plan=fresh)] == want
