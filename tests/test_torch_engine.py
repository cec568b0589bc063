"""The port's engine end to end, against the JAX engine and the host oracle.

The port runs on the CPU with small chunks (``chunk_bytes=1<<17``, as the
JAX engine runs under ``tests/conftest.py``) and builds its own tables from
its own vocabulary code; the JAX engine and the JAX package's oracle are the
references. All comparisons are exact.
"""

import pathlib
import random
import subprocess
import sys

import pytest
import torch

from jtokkit_tpu.engine.device import DeviceEngine as JaxEngine
from jtokkit_tpu.engine.oracle import OracleEngine as JaxOracle
from jtokkit_tpu.vocab.definitions import BUILTIN_DEFINITIONS
from jtokkit_tpu.vocab.loader import load_builtin_ranks
from jtokkit_tpu_torch.engine.device import DeviceEngine
from jtokkit_tpu_torch.engine.oracle import OracleEngine
from jtokkit_tpu_torch.ops import scan
from jtokkit_tpu_torch.vocab import loader as port_loader

from .conftest import load_conformance_rows

# The suite runs in several worker processes at once; torch's own thread
# pool in each of them would oversubscribe the cores.
torch.set_num_threads(1)

_CACHE = {}

EDGE_CASES = [
    "", None, " ", "   \t\n  \r\n   ", "a", "\x00\x01\x1c\x7f\xff?",
    "中文" * 300, "🙂" * 150, "word " * 400, "1234567890" * 30,
    "'s't're've'm'll'd 'S'T'RE", "<|endoftext|>", "　　a",
]


def engines(name):
    """(JAX oracle, JAX engine, port engine on the CPU). The port engine keeps
    long-piece chunks on the device merge (``native_long=False``): these
    tests hold the device path, and ``tests/test_torch_native.py`` the
    routing."""
    if name not in _CACHE:
        d = BUILTIN_DEFINITIONS[name]
        orc = JaxOracle(
            d.name, d.pattern, load_builtin_ranks(d.vocab_name), d.special_tokens
        )
        port_orc = OracleEngine(
            d.name, d.pattern, port_loader.load_builtin_ranks(d.vocab_name),
            d.special_tokens,
        )
        _CACHE[name] = (
            orc,
            JaxEngine.from_oracle(orc),
            DeviceEngine.from_oracle(
                port_orc, device="cpu", chunk_bytes=1 << 17, native_long=False
            ),
        )
    return _CACHE[name]


def _fuzz(seed, n):
    rng = random.Random(seed)
    bits = [
        "ab", "'s", "'RE", "'ſ", "1234", "  ", "\t", " ", "\n", "\r\n",
        "!!", "—", "中文", "🙂", "　", "\xa0", "x", "$", "'", "é", "ß",
    ]
    return [
        "".join(rng.choice(bits) for _ in range(rng.randint(0, 20)))
        for _ in range(n)
    ]


def check_batch(name, texts):
    orc, jax_eng, port = engines(name)
    got = port.encode_ordinary_batch(texts)
    want = jax_eng.encode_ordinary_batch(texts)
    assert got == want
    for t, g in zip(texts, got):
        assert g == orc.encode_ordinary(t)[0], repr(t)
    assert port.count_tokens_batch(texts) == [len(g) for g in got]


@pytest.mark.parametrize("part", ["conformance", "edge", "fuzz"])
def test_engine_matches_jax_and_oracle(enc_name, part):
    if part == "conformance":
        texts = [t for t, _, _ in load_conformance_rows(enc_name)]
    elif part == "edge":
        texts = EDGE_CASES
    else:
        texts = _fuzz(99, 300)
    port = engines(enc_name)[2]
    before = (port.fallback_chunks, port.host_pieces)
    check_batch(enc_name, texts)
    assert (port.fallback_chunks, port.host_pieces) == before


def test_long_piece_goes_to_the_host():
    """A 5000-byte piece is longer than the largest merge bucket: its chunk
    takes the fallback, which merges that piece (and the 4500-byte one) on
    the host and the rest of the chunk on the device."""
    orc, _jax, port = engines("cl100k_base")
    chunks, pieces = port.fallback_chunks, port.host_pieces
    texts = ["a" * 5000, "short text", "x " + "b" * 4500 + " y"]
    got = port.encode_ordinary_batch(texts)
    assert got == [orc.encode_ordinary(t)[0] for t in texts]
    assert port.fallback_chunks == chunks + 1
    assert port.host_pieces == pieces + 2
    assert port.count_tokens_batch(texts) == [len(g) for g in got]
    assert port.fallback_chunks == chunks + 2
    assert port.host_pieces == pieces + 4


def test_capacity_retry_is_exact():
    """All-1-byte pieces overflow the primary piece table; the roomy retry
    (a second Stage A run with 5 more scans) keeps the chunk on the device."""
    orc, _jax, port = engines("cl100k_base")
    text = "a1" * 30_000
    runs, calls, host = port.stage_a_runs, scan.PLAIN_CALLS, port.fallback_chunks
    got = port.encode_ordinary_batch([text])
    assert got[0] == orc.encode_ordinary(text)[0]
    assert port.stage_a_runs - runs == 2
    assert scan.PLAIN_CALLS - calls == 5 * 2
    assert port.fallback_chunks == host


def test_multi_chunk_documents():
    """Documents larger than a chunk are split at safe points and their
    tokens concatenate in order."""
    orc, jax_eng, port = engines("cl100k_base")
    para = "The quick brown fox jumps over 13 lazy dogs.\n" * 4000
    texts = [para, "mid", para[:-1] + "中文\r\n"]
    got = port.encode_ordinary_batch(texts)
    assert got == jax_eng.encode_ordinary_batch(texts)
    assert got == [orc.encode_ordinary(t)[0] for t in texts]
    assert port.count_tokens_batch(texts) == [len(g) for g in got]


def test_empty_batch():
    _orc, _jax, port = engines("r50k_base")
    assert port.encode_ordinary_batch([]) == []
    assert port.count_tokens_batch([]) == []


def test_public_facade_on_cpu():
    from jtokkit_tpu_torch import Encodings, EncodingType, SpecialTokenError

    reg = Encodings.new_lazy_encoding_registry(device="cpu")
    enc = reg.get_encoding(EncodingType.CL100K_BASE)
    texts = ["Hello, world!", "I'm 42 — ĄĘ中🙂", "", None]
    assert enc.device_engine().device == torch.device("cpu")
    assert enc.encode("Hello, world!") == [9906, 11, 1917, 0]
    assert enc.encode_ordinary_batch(texts) == [enc.encode_ordinary(t) for t in texts]
    assert enc.encode_batch(texts[:2]) == [enc.encode(t) for t in texts[:2]]
    assert enc.count_tokens_batch(texts) == [len(enc.encode(t)) for t in texts]
    with pytest.raises(SpecialTokenError):
        enc.count_tokens_batch(["a <|endoftext|>"])
    assert enc.decode(enc.encode("round trip ✓")) == "round trip ✓"
    assert reg.get_encoding_for_model("gpt-4-0314") is enc


def test_entry_points_raise_without_cuda(monkeypatch):
    import jtokkit_tpu_torch
    from jtokkit_tpu_torch.encoding_impl import GptBytePairEncoding

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        jtokkit_tpu_torch.Encodings.new_default_encoding_registry()
    with pytest.raises(RuntimeError, match="CUDA"):
        jtokkit_tpu_torch.Encodings.new_lazy_encoding_registry()
    _orc, _jax, port = engines("r50k_base")
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceEngine.from_oracle(port.oracle)
    with pytest.raises(RuntimeError, match="CUDA"):
        GptBytePairEncoding(
            jtokkit_tpu_torch.GptBytePairEncodingParams(
                "x", "gpt2", {bytes([b]): b for b in range(256)}, {}
            )
        )


_IMPORT_CHECK = """
import sys

def banned(name):
    return name.split(".")[0] in ("jax", "jaxlib", "jtokkit_tpu")

for name in [m for m in sys.modules if banned(m)]:
    del sys.modules[name]

class Block:
    def find_spec(self, name, path=None, target=None):
        if banned(name):
            raise ImportError("imported " + name)

sys.meta_path.insert(0, Block())
import importlib
import pkgutil

import jtokkit_tpu_torch

def fail(name):
    raise ImportError("could not import " + name)

names = [
    m.name for m in pkgutil.walk_packages(
        jtokkit_tpu_torch.__path__, "jtokkit_tpu_torch.", onerror=fail
    )
]
for name in names:
    importlib.import_module(name)
print(" ".join(names))
"""


def test_import_leaves_jax_out():
    """No module of the port imports JAX or the JAX package: every module
    found by walking the package is imported in a fresh interpreter with
    both blocked."""
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_CHECK], capture_output=True, text=True,
        cwd=str(pathlib.Path(__file__).resolve().parents[1]),
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    walked = set(proc.stdout.split())
    for name in (
        "engine.device", "ops.scan", "ops.gather", "scripts.profile_gather",
        "native", "parallel.mesh", "parallel.sharded", "cli",
        "recipes.chatml", "entry", "bench",
    ):
        assert f"jtokkit_tpu_torch.{name}" in walked, name
