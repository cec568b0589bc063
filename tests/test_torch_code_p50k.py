"""The port on Python source under ``p50k_base``: the text of the benchmark's
``codex-p50k-encode`` cell (``tokbench/configs/p50k-codex-python.json``,
``tokbench/text/python-stdlib*.json``) and hand-made code, against the
benchmark's plain reference (``tokbench/reference/``), document by
document.

Source code is what works p50k's 24 space-run tokens (ranks 50257-50280,
runs of 2-25 spaces: those over 16 bytes are longer than the word table's
rows and must merge) and the gpt2 rule ``\\s+(?!\\S)`` on indentation. Its
~50 K pieces a MiB that miss the word table overflow the ASCII chunk's
primary miss table, so full chunks take the capacity retry: the engine's
``retried_chunks`` and ``capacity_retry`` span count it.

Port engines run on the CPU (``device="cpu"``), with the graph cache's
code path and without it; the text is seeded. Every comparison is exact
(integer ids: tolerance 0). Only the Stage A parity case imports the JAX
package.
"""

import json
import os

import numpy as np
import pytest
import torch

from jtokkit_tpu_torch.engine import device as device_mod
from jtokkit_tpu_torch.engine.device import DeviceEngine
from jtokkit_tpu_torch.engine.oracle import OracleEngine
from jtokkit_tpu_torch.ops import stage4
from jtokkit_tpu_torch.vocab.definitions import BUILTIN_DEFINITIONS
from jtokkit_tpu_torch.vocab.loader import load_builtin_ranks
from tokbench import ring
from tokbench.reference import Reference

# The suite runs in several worker processes at once; torch's own thread
# pool in each of them would oversubscribe the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = 1 << 16
# the word table's rows hold tokens of at most this many bytes
WORD_BYTES = 16
_CACHE = {}


def reference() -> Reference:
    if "ref" not in _CACHE:
        _CACHE["ref"] = Reference(
            os.path.join(REPO, "jtokkit_tpu/vocab/assets/p50k_base.tiktoken"), "gpt2")
    return _CACHE["ref"]


def oracle() -> OracleEngine:
    if "oracle" not in _CACHE:
        d = BUILTIN_DEFINITIONS["p50k_base"]
        _CACHE["oracle"] = OracleEngine(d.name, d.pattern,
                                        load_builtin_ranks(d.vocab_name),
                                        d.special_tokens)
    return _CACHE["oracle"]


def port(chunk_bytes: int = SMALL, **kw) -> DeviceEngine:
    """A fresh CPU engine over p50k (fresh, so that its counters start at
    0)."""
    return DeviceEngine.from_oracle(oracle(), device="cpu", chunk_bytes=chunk_bytes,
                                    **kw)


def check_docs(texts, got):
    ref = reference()
    assert len(got) == len(texts)
    for t, g in zip(texts, got):
        np.testing.assert_array_equal(np.asarray(g, np.int64), ref.encode(t),
                                      err_msg=repr(t[:80]))


def reference_pieces(texts):
    """(pieces, pieces that are not one token of at most 16 bytes: the ones
    Stage A sends to the merge) by the reference's pre-split."""
    ref = reference()
    pieces = misses = 0
    for t in texts:
        for a, b in ref.split(t):
            p = t[a:b].encode("utf-8")
            pieces += 1
            misses += not (len(p) <= WORD_BYTES and p in ref.ranks)
    return pieces, misses


def small_ring(seed: int):
    """The cell's configuration and traffic cut to batches of 160 KiB (a few
    64 KiB chunks) and files of at most 8 KiB."""
    with open(os.path.join(REPO, "tokbench/configs/p50k-codex-python.json")) as f:
        config = json.load(f)
    with open(os.path.join(REPO, "tokbench/traffic/codex-encode.json")) as f:
        traffic = json.load(f)
    config["documents"].update(median_bytes=1500, max_bytes=8192)
    traffic.update(batch_bytes=160 * 1024, ring_min_batches=2,
                   ring_min_bytes=320 * 1024)
    return ring.build_ring(config, traffic, seed, os.path.join(REPO, "tokbench"))


@pytest.mark.parametrize("cold_cache", [False, True])
def test_ring_of_the_cell_equals_the_reference(cold_cache):
    """Every batch of a small seeded ring of the cell's text through the
    port's default routing; the engine's piece counters equal the
    reference's pre-split, and a chunk with a non-ASCII line takes the
    ``"unicode"`` Stage A."""
    r = small_ring(2**31 + 48)
    assert {s for x in r.scripts for s in x} == {"python-stdlib",
                                                 "python-stdlib-nonascii"}
    texts = [t for b in r.batches for t in b]
    assert any(not t.isascii() for t in texts)
    eng = port(cold_cache=cold_cache)
    for batch in r.batches:
        check_docs(batch, eng.encode_ordinary_batch_arrays(batch))
    pieces, misses = reference_pieces(texts)
    assert eng.pieces == pieces and eng.miss_pieces == misses
    assert 0.15 < misses / pieces < 0.3
    assert eng.unicode_chunks >= 1
    assert eng.native_chunks == 0 and eng.fallback_chunks == 0


def _indented(rng):
    lines = []
    for k in range(1, 41):
        lines.append(" " * k + "x = foo(y)")          # indentation before a word
        lines.append("z = 1" + " " * k)                # trailing spaces at a line's end
        lines.append(" " * k)                          # a line of spaces only
    order = rng.permutation(len(lines))
    return "\n".join(lines[i] for i in order) + "\n"


HAND_MADE = {
    "indentation": _indented(np.random.default_rng(7)),
    # runs around the word table's 16-byte rows and p50k's longest run (25)
    "space_runs": "".join(f"a{' ' * n}b\n{' ' * n}c\nd{' ' * n}\n"
                          for n in (15, 16, 17, 24, 25, 26, 27, 50)),
    "tabs_crlf": "def f(x):\r\n\treturn x\r\n\r\n\t\tif x:\t# tab\r\n    \t  pass\r\n",
    "non_ascii": "def f():\n    # Łukasz Langa, Martin v. Löwis: ± ≠ 中文 🙂\n"
                 "    return 'naïve'\n",
}


@pytest.mark.parametrize("cold_cache", [False, True])
@pytest.mark.parametrize("case", list(HAND_MADE))
def test_hand_made_code_equals_the_reference(case, cold_cache):
    text = HAND_MADE[case]
    docs = [text, text * 3, "x" + text, text.rstrip("\n")]
    eng = port(cold_cache=cold_cache)
    check_docs(docs, eng.encode_ordinary_batch_arrays(docs))
    assert eng.unicode_chunks == (0 if text.isascii() else 1)
    assert eng.count_tokens_batch(docs) == [len(reference().encode(t)) for t in docs]


def test_long_space_runs_merge_to_p50k_tokens():
    """p50k's space runs: 2-25 spaces are one token each, a run over 25 is
    split, and runs over 16 bytes (longer than a word-table row) still come
    out as their one token."""
    ref = reference()
    eng = port()
    for n in (2, 16, 17, 24, 25):
        want = ref.ranks[b" " * n]
        assert 50257 <= want <= 50280
        # a line of n spaces then a word: the gpt2 rule leaves the run's
        # last space to the word
        (got,) = eng.encode_ordinary_batch_arrays([" " * (n + 1) + "x"])
        assert got[0] == want
    (got,) = eng.encode_ordinary_batch_arrays(["\n" + " " * 30 + "\n"])
    check_docs(["\n" + " " * 30 + "\n"], [got])


def code_docs(n_bytes: int, seed: int, script: str = "python-stdlib"):
    """Documents of 500-6,000 bytes of whole phrases (1-16 lines of code)
    drawn by the benchmark's generator, about ``n_bytes`` in all."""
    spec = ring.load_text_spec(script)
    rng = ring.rng_for(seed, 7)
    draw = ring._sentences(spec, 1.0)
    sizes = rng.integers(500, 6000, 4096).tolist()
    out, cur, total = [], b"", 0
    for phrase in draw(rng, 8192):
        cur += phrase
        if len(cur) >= sizes[len(out)]:
            out.append(cur.decode("utf-8"))
            total += len(cur)
            cur = b""
            if total >= n_bytes:
                break
    return out


@pytest.mark.parametrize("cold_cache", [False, True])
def test_full_chunks_of_code_take_the_capacity_retry(cold_cache):
    """Chunks of 16 KiB of ASCII code hold ~780 pieces for the merge, over
    the 512 rows of the ASCII variant's primary miss table (16 KiB / 32):
    each full chunk runs Stage A again at the roomy capacities in the
    ``capacity_retry`` span, and the ids stay exact."""
    texts = code_docs(60_000, seed=2**31 + 5)
    assert all(t.isascii() for t in texts)
    n_chunks = len(list(port(chunk_bytes=1 << 14)._plan_chunks(texts)))
    eng = port(chunk_bytes=1 << 14, cold_cache=cold_cache)
    got = eng.encode_ordinary_batch_arrays(texts)
    check_docs(texts, got)
    assert eng.capacity_retries == 1
    assert 0 < eng.retried_chunks <= n_chunks
    assert eng.stage_a_runs == n_chunks + eng.retried_chunks
    # the retry's Stage A and metas read, inside the stage_a span
    assert 0 < eng.capacity_retry_ns <= eng.stage_a_ns
    assert eng.unicode_chunks == 0
    assert (eng.pieces, eng.miss_pieces) == reference_pieces(texts)


@pytest.mark.parametrize("variant", ["ascii", "unicode"])
def test_stage_a_metas_equal_the_jax_package(variant):
    """The port's Stage A metas (overflow bits, ``n_pieces``, bucket counts)
    over one 16 KiB chunk of code, at the variant's primary and at the roomy
    capacities, equal the JAX package's ``stage_a_v4``."""
    import jax.numpy as jnp

    from jtokkit_tpu.engine.device import DeviceEngine as JaxEngine
    from jtokkit_tpu.engine.oracle import OracleEngine as JaxOracle
    from jtokkit_tpu.vocab.definitions import BUILTIN_DEFINITIONS as JAX_DEFS
    from jtokkit_tpu.vocab.loader import load_builtin_ranks as jax_ranks

    d = JAX_DEFS["p50k_base"]
    jax_eng = JaxEngine.from_oracle(
        JaxOracle(d.name, d.pattern, jax_ranks(d.vocab_name), d.special_tokens))
    eng = port(chunk_bytes=1 << 14)
    texts = code_docs(24_000, seed=11)
    if variant == "unicode":
        texts[0] = HAND_MADE["non_ascii"] + texts[0]
    buf, doc_ends, _parts, ascii_only = next(iter(eng._plan_chunks(texts)))
    assert ascii_only == (variant == "ascii")
    primary = (device_mod._DIVS_PRIMARY if variant == "ascii"
               else device_mod._DIVS_PRIMARY_UNICODE)
    overflowed = []
    for divs in (primary, device_mod._DIVS_ROOMY):
        _table, want = jax_eng._stage_a(variant, divs)(jnp.asarray(buf),
                                                       jnp.asarray(doc_ends))
        _t, got = eng._stage_a(variant, divs, torch.from_numpy(buf),
                               torch.from_numpy(doc_ends))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=str(divs))
        overflowed.append(bool(int(got[0]) & stage4.OVERFLOW_CAPACITY))
    # a full ASCII chunk of code overflows the primary miss table; the
    # roomy capacities hold any input
    assert overflowed == [variant == "ascii", False]
