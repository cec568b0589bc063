"""Throughput benchmark of the port, with the reference's protocol.

Counterpart of ``jtokkit_tpu/bench.py`` (:func:`run`, :func:`run_scaling`)
and of the root ``bench.py``'s line contract (:func:`main`)::

    python -m jtokkit_tpu_torch.bench                 # headline, companions, headline
    python -m jtokkit_tpu_torch.bench --fast          # the headline line only
    python -m jtokkit_tpu_torch.bench --mode device-count --mb 16
    python -m jtokkit_tpu_torch.bench --device cpu --mb 1 --fast

The reference preloads a 265 MB Gutenberg corpus into RAM and measures
full-corpus encode passes (reference ``benchmark/README.md:9-11``,
``benchmark/.../AbstractBenchmark.java:26-38``). Here the corpus is the
seeded synthetic Gutenberg-like corpus of ``utils/corpus.py`` (or a file),
preloaded on the host and, for the device modes, on the engine's device as a
``CorpusPlan``. Reported throughput = corpus UTF-8 bytes / wall-clock
seconds of the best measured pass, after the warm-up passes that bring the
engine to its steady state (the cold pass that fills the plan's cache, for
the encodes the pass that caches the token counts, and the pass that
captures the CUDA graphs), so that on a card every measured encode or count
pass is graph replays.

Modes:
  device        honest encode: every document's token ids as an int32 array
                in host RAM (``encode_ordinary_batch_arrays`` over the plan;
                on a card one graph replay per chunk and one wait)
  device-lists  same plus Python list conversion (reference output shape)
  device-count  token counting only (no token fetch): on a card, CUDA graph
                replays and one scalar fetch per pass
  decode        the corpus's tokens back to bytes by the numpy host decode
                (``decode_bytes_batch_host``: what the JAX package's
                ``decode_bytes_batch`` is)
  device-decode the same on the engine's device (``decode_bytes_batch_device``)
  host          pure-Python oracle
  native / native-mt   C++ host engine, single / all threads
  tiktoken      comparison point built from local rank files, where the
                tiktoken package is installed
  sharded / sharded-count   ``ShardedTokenizer`` encode / count over the
                default process group, or a world-1 group that :func:`run`
                makes and destroys

``device=None`` means the CUDA card, and the modes that run on a device
raise without one; ``device="cpu"`` runs the kernels' plain versions.

Baseline for comparison: JTokkit single-thread per-encoding scores
(reference ``benchmark/reports/jtokkit.txt:26-29``), e.g. cl100k_base
14.144 s for 265 MB ≈ 18.7 MB/s on a Ryzen 9 5900X CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import tempfile
import time
from typing import Optional

import torch
import torch.distributed as dist

from .engine.device import CHUNK_BYTES, resolve_device

_T0 = time.time()  # about the process start when run as ``python -m``

BASELINE_MBPS = {
    # 265 MB / single-thread JMH score (reference benchmark/reports/jtokkit.txt)
    "cl100k_base": 265.0 / 14.144,
    "r50k_base": 265.0 / 12.263,
    "p50k_base": 265.0 / 12.800,
    "p50k_edit": 265.0 / 13.404,
}

MODES = (
    "device", "device-lists", "device-count", "decode", "device-decode",
    "host", "native", "native-mt", "tiktoken", "sharded", "sharded-count",
)

# companion sweep of the default invocation, cheapest first (the engine
# cache makes same-encoding modes nearly free after the headline; other
# encodings build their tables). (encoding, flavor, mode, mb)
COMPANIONS = (
    ("cl100k_base", "english", "device-count", None),  # compute-side ceiling
    ("cl100k_base", "english", "sharded", 8),
    ("cl100k_base", "mixed", "device", 8),
    ("cl100k_base", "cjk", "device", 4),
    ("r50k_base", "english", "device", 8),
    ("p50k_base", "english", "device", 8),
    ("p50k_edit", "english", "device", 8),
)

# the pre-tokenization regexes, for the tiktoken comparison point
_TIKTOKEN_PATTERNS = {
    "gpt2": r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""",
    "cl100k": r"""(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+""",
}


def _load_corpus(mb: float, corpus: Optional[str], flavor: str):
    if corpus:
        with open(corpus, "r", encoding="utf-8") as f:
            text = f.read()
        # split into ~64KB docs on line boundaries
        docs, cur, size = [], [], 0
        for line in text.splitlines(keepends=True):
            cur.append(line)
            size += len(line)
            if size >= 64 * 1024:
                docs.append("".join(cur))
                cur, size = [], 0
        if cur:
            docs.append("".join(cur))
        return docs
    from .utils.corpus import generate

    return generate(mb, seed=0, flavor=flavor)


def _best_of(passes: int, fn):
    """(least seconds of ``passes`` calls, the last call's result). Every
    timed call returns host data, so it ends synchronised with the device."""
    best = float("inf")
    out = None
    for _ in range(passes):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return best, out


# process-lifetime caches: repeated run() calls (companion sweeps) reuse the
# oracle and the device engine. The DeviceEngine is keyed by (vocab asset,
# pattern, device, chunk size), so p50k_edit shares p50k_base's engine — they
# differ only in special tokens, which encode_ordinary ignores (reference
# M/EncodingFactory.java:92 shares the rank file the same way).
_ORACLES: dict = {}
_ENGINES: dict = {}


def _oracle(encoding: str):
    orc = _ORACLES.get(encoding)
    if orc is None:
        from .engine.oracle import OracleEngine
        from .vocab.definitions import BUILTIN_DEFINITIONS
        from .vocab.loader import load_builtin_ranks

        d = BUILTIN_DEFINITIONS[encoding]
        orc = OracleEngine(
            d.name, d.pattern, load_builtin_ranks(d.vocab_name),
            d.special_tokens,
        )
        _ORACLES[encoding] = orc
    return orc


def _device_engine(encoding: str, device=None, chunk_bytes: int = CHUNK_BYTES):
    from .vocab.definitions import BUILTIN_DEFINITIONS
    from .vocab.loader import asset_path

    d = BUILTIN_DEFINITIONS[encoding]
    dev = resolve_device(device)
    key = (asset_path(d.vocab_name), d.pattern, str(dev), int(chunk_bytes))
    eng = _ENGINES.get(key)
    if eng is None:
        from .engine.device import DeviceEngine

        eng = DeviceEngine.from_oracle(
            _oracle(encoding), device=dev, chunk_bytes=chunk_bytes
        )
        _ENGINES[key] = eng
    return eng


def _device_detail(dev: torch.device) -> dict:
    """The device a run used, and on a card its name and power limit."""
    if dev.type != "cuda":
        return {"device": str(dev)}
    from .scripts.profile_gather import card_line

    return {"device": str(dev), "card": card_line()}


def _device_activity(trace_path: str) -> dict:
    """Device activity in a chrome trace: kernels, copies and fills merged
    into busy intervals; the idle gaps between them are where the card
    waited for the host."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted(
        (e["ts"], e["ts"] + e.get("dur", 0)) for e in events
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
    )
    start = end = spans[0][0] if spans else 0.0
    busy, gaps = 0.0, []
    for lo, hi in spans:
        if lo > end:
            gaps.append(lo - end)
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return {
        "device_ms": busy / 1e3,
        "kernels": sum(1 for e in events
                       if e.get("ph") == "X" and e.get("cat") == "kernel"),
        "span_ms": (end - start) / 1e3,
        "max_gap_ms": max(gaps, default=0.0) / 1e3,
        "gaps_over_0.1ms": sum(1 for g in gaps if g > 100),
    }


@contextlib.contextmanager
def _profile(profile_dir: Optional[str], label: str, dev, detail: dict, engine=None):
    """torch.profiler around the MEASURED passes only (``profile_dir``): CPU
    activity, and the card's on a CUDA device. One chrome trace per run goes
    into ``profile_dir``; ``detail["profile"]`` sums it up."""
    if profile_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    from .ops import scan

    on_card = dev is not None and dev.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(
        profile_dir, f"{label}_{os.getpid()}_{time.time_ns()}.trace.json"
    )

    def counters():
        if engine is None:
            return {}
        return {"graph_replays": engine.graph_replays,
                "host_reads": engine.host_reads,
                "scan_launches": scan.KERNEL_LAUNCHES}

    before = counters()
    with profile(activities=activities) as prof:
        t = time.perf_counter()
        yield
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
    prof.export_chrome_trace(path)
    summary = {"trace": path, "wall_ms": wall * 1e3}
    summary.update({k: v - before[k] for k, v in counters().items()})
    if on_card:
        summary.update(_device_activity(path))
        summary["busy"] = summary["device_ms"] / summary["wall_ms"]
    detail["profile_dir"] = profile_dir
    detail["profile"] = summary


@contextlib.contextmanager
def _data_group(dev: torch.device):
    """The default process group if one exists (e.g. under ``torchrun``);
    else a world-1 group over a file store in a temporary directory, on
    ``dev``'s backend, destroyed on the way out (a group left behind would
    break the next ``initialize_distributed`` in this process)."""
    if dist.is_initialized():
        yield
        return
    from .parallel.mesh import initialize_distributed

    with tempfile.TemporaryDirectory() as tmp:
        initialize_distributed(f"file://{tmp}/store", 1, 0, device=dev)
        try:
            yield
        finally:
            dist.destroy_process_group()


def _check_sample(docs, encode_batch, orc, what: str) -> None:
    """Three sampled documents through ``encode_batch`` against the oracle."""
    import random

    rng = random.Random(0)
    sample = rng.sample(range(len(docs)), min(3, len(docs)))
    enc_out = encode_batch([docs[i] for i in sample])
    for k, i in enumerate(sample):
        if enc_out[k] != orc.encode_ordinary(docs[i])[0]:
            raise AssertionError(f"{what}parity failure on doc {i}")


def run(
    mb: float = 16,
    encoding: str = "cl100k_base",
    mode: str = "device",
    corpus: Optional[str] = None,
    flavor: str = "english",
    passes: int = 3,
    verify: bool = True,
    threads: Optional[int] = None,
    profile_dir: Optional[str] = None,
    *,
    device=None,
    chunk_bytes: int = CHUNK_BYTES,
) -> dict:
    """One measurement: ``{"metric", "value" (MB/s), "unit", "vs_baseline",
    "detail"}``. ``device`` and ``chunk_bytes`` go to the device engine (the
    host modes use neither)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    orc = _oracle(encoding)
    from .vocab.definitions import BUILTIN_DEFINITIONS

    d = BUILTIN_DEFINITIONS[encoding]

    docs = _load_corpus(mb, corpus, flavor)
    nbytes = sum(len(t.encode("utf-8")) for t in docs)
    detail = {}
    where = "host"

    if mode == "host":
        with _profile(profile_dir, mode, None, detail):
            elapsed, out = _best_of(
                1, lambda: [orc.encode_ordinary(t)[0] for t in docs]
            )
        total = sum(len(t) for t in out)
    elif mode in ("native", "native-mt"):
        # reference protocol analog: single- and multi-threaded host passes
        # (the JMH benches fan files over a thread pool, reference
        # benchmark/.../AbstractMultiThreadedBenchmark.java:35-45; the C ABI
        # releases the GIL so Python threads scale). The shared engine of
        # native.engine_for: a sweep would otherwise use up the table slots.
        from . import native
        from .vocab.loader import asset_path
        from .vocab.tables import load_packed

        packed = load_packed(
            d.vocab_name, orc.ranks, asset_path(d.vocab_name)
        )
        nat = native.engine_for(packed, d.pattern)
        if nat is None:
            raise RuntimeError(f"the native engine does not serve {encoding}")
        nat.encode_ordinary(docs[0])  # warm
        if mode == "native":
            with _profile(profile_dir, mode, None, detail):
                elapsed, out = _best_of(
                    passes,
                    lambda: [nat.encode_ordinary_array(t) for t in docs],
                )
            total = sum(len(t) for t in out)
        else:
            import concurrent.futures as cf

            workers = threads or os.cpu_count() or 2
            with cf.ThreadPoolExecutor(workers) as pool:
                with _profile(profile_dir, mode, None, detail):
                    elapsed, out = _best_of(passes, lambda: list(
                        pool.map(nat.encode_ordinary_array, docs)
                    ))
            total = sum(len(t) for t in out)
            detail["threads"] = workers
    elif mode == "tiktoken":
        # comparison point (reference benchmark/bench.py drives tiktoken's
        # encode_ordinary_batch); constructed from local rank files
        try:
            import tiktoken
        except ImportError as e:
            raise ImportError(
                "mode 'tiktoken' needs the tiktoken package, which is not "
                "installed here; the benchmark installs nothing"
            ) from e
        tk = tiktoken.Encoding(
            name=encoding, pat_str=_TIKTOKEN_PATTERNS[d.pattern],
            mergeable_ranks=orc.ranks, special_tokens=d.special_tokens,
        )
        with _profile(profile_dir, mode, None, detail):
            elapsed, out = _best_of(
                passes, lambda: tk.encode_ordinary_batch(docs)
            )
        total = sum(len(t) for t in out)
    elif mode in ("sharded", "sharded-count"):
        # data parallel over every rank of the group (one card: world 1, a
        # sanity point; gloo ranks on the CPU exercise real sharding).
        # Mirrors the reference's multi-thread JMH fan-out
        # (benchmark/.../AbstractMultiThreadedBenchmark.java:35-45).
        from .parallel.sharded import ShardedTokenizer

        eng = _device_engine(encoding, device, chunk_bytes)
        with _data_group(eng.device):
            tok = ShardedTokenizer(eng)
            plan = tok.preload_corpus(docs)
            total = tok.count_tokens_corpus(None, plan=plan)  # cold pass
            if mode == "sharded-count":
                tok.count_tokens_corpus(None, plan=plan)  # captures the graphs
                with _profile(profile_dir, mode, eng.device, detail, eng):
                    elapsed, got = _best_of(
                        passes, lambda: tok.count_tokens_corpus(None, plan=plan)
                    )
                if got != total:
                    raise AssertionError(f"sharded count {got} != {total}")
            else:
                tok.encode_ordinary_batch_arrays(None, plan=plan)  # caches the counts
                tok.encode_ordinary_batch_arrays(None, plan=plan)  # captures the graphs
                with _profile(profile_dir, mode, eng.device, detail, eng):
                    elapsed, out = _best_of(
                        passes,
                        lambda: tok.encode_ordinary_batch_arrays(None, plan=plan),
                    )
                if sum(len(a) for a in out) != total:
                    raise AssertionError("sharded encode differs from its count")
            detail["n_devices"] = tok.n_dev
            detail.update(_device_detail(eng.device))
            where = f"{tok.n_dev}-rank group"
            if verify:
                _check_sample(docs, tok.encode_ordinary_batch, orc, "sharded ")
    else:
        eng = _device_engine(encoding, device, chunk_bytes)
        # corpus preloaded to the device, mirroring the reference protocol's
        # RAM-preloaded corpus (reference benchmark/README.md:9-11); the
        # steady-state passes measure the encode pipeline, not the upload
        plan = eng.preload_corpus(docs)
        total = eng.count_tokens_corpus(docs, plan=plan)  # cold pass
        prof = functools.partial(_profile, profile_dir, mode, eng.device, detail, eng)
        if mode == "device-count":
            eng.count_tokens_corpus(docs, plan=plan)  # captures the graphs
            with prof():
                elapsed, got = _best_of(
                    passes, lambda: eng.count_tokens_corpus(docs, plan=plan)
                )
            if got != total:
                raise AssertionError(f"count {got} != {total}")
        elif mode in ("decode", "device-decode"):
            # decode throughput over the corpus's own tokens; value is
            # decoded UTF-8 bytes per second (same denominator as encode).
            # "decode" = the vectorized numpy host gather (the JAX engine's
            # default); "device-decode" = the decode on the engine's device.
            token_lists = eng.encode_ordinary_batch_arrays(None, plan=plan)
            dec = (eng.decode_bytes_batch_device if mode == "device-decode"
                   else eng.decode_bytes_batch_host)
            dec(token_lists)  # warm
            with prof():
                elapsed, out = _best_of(passes, lambda: dec(token_lists))
            if sum(len(b) for b in out) != nbytes:
                raise AssertionError("decoded bytes differ from the corpus size")
        else:
            eng.encode_ordinary_batch_arrays(None, plan=plan)  # caches the counts
            eng.encode_ordinary_batch_arrays(None, plan=plan)  # captures the graphs
            if mode == "device-lists":
                with prof():
                    elapsed, out = _best_of(passes, lambda: [
                        a.tolist()
                        for a in eng.encode_ordinary_batch_arrays(None, plan=plan)
                    ])
            else:  # device: honest encode, int32 array per document
                with prof():
                    elapsed, out = _best_of(
                        passes,
                        lambda: eng.encode_ordinary_batch_arrays(None, plan=plan),
                    )
            if sum(len(t) for t in out) != total:
                raise AssertionError("encode differs from its count")
        detail.update(_device_detail(eng.device))
        where = "1 card" if eng.device.type == "cuda" else eng.device.type
        if verify:
            _check_sample(docs, eng.encode_ordinary_batch, orc, "")

    mbps = nbytes / elapsed / 1e6
    baseline = BASELINE_MBPS.get(encoding, BASELINE_MBPS["cl100k_base"])
    detail.update({
        "corpus_mb": round(nbytes / 1e6, 2),
        "flavor": flavor,
        "tokens": int(total),
        "seconds": round(elapsed, 3),
        "baseline_mbps": round(baseline, 1),
        "baseline": f"JTokkit {encoding} 1-thread, Ryzen 9 5900X "
        "(reference benchmark/reports/jtokkit.txt)",
    })
    return {
        "metric": f"{encoding} encode throughput ({mode}, {where})",
        "value": round(mbps, 2),
        "unit": "MB/s",
        "vs_baseline": round(mbps / baseline, 2),
        "detail": detail,
    }


def _scaling_rank(rank, n_ranks, port, kind, mb_per_dev, encoding, flavor,
                  passes, chunk_bytes) -> None:
    """One rank of :func:`run_scaling` (run in a child process): its shard
    of the corpus, timed sharded counts; rank 0 prints its row as JSON."""
    from .ops import scan
    from .parallel.mesh import initialize_distributed
    from .parallel.sharded import ShardedTokenizer
    from .utils.corpus import generate

    rank, n_ranks = int(rank), int(n_ranks)
    if kind == "cpu":
        torch.set_num_threads(1)  # one core per rank
    dev = initialize_distributed(f"tcp://localhost:{port}", n_ranks, rank, device=kind)
    try:
        eng = _device_engine(encoding, dev, int(chunk_bytes))
        tok = ShardedTokenizer(eng)
        docs = generate(float(mb_per_dev) * n_ranks, seed=0, flavor=flavor)
        nbytes = sum(len(t.encode("utf-8")) for t in docs)
        plan = tok.preload_corpus(docs)
        total = tok.count_tokens_corpus(None, plan=plan)  # cold pass
        tok.count_tokens_corpus(None, plan=plan)  # captures the graphs
        elapsed, got = _best_of(
            int(passes), lambda: tok.count_tokens_corpus(None, plan=plan)
        )
        if got != total:
            raise RuntimeError(f"rank {rank}: count {got} != {total}")
        if rank == 0:
            print(json.dumps({
                "mbps": nbytes / elapsed / 1e6, "nbytes": nbytes, "tokens": total,
                "seconds": elapsed, "backend": dist.get_backend(),
                "device": str(dev), "scan_launches": scan.KERNEL_LAUNCHES,
            }), flush=True)
    finally:
        dist.destroy_process_group()


def run_scaling(
    mb_per_dev: float = 4.0,
    encoding: str = "cl100k_base",
    flavor: str = "english",
    passes: int = 3,
    sizes=None,
    *,
    device=None,
    timeout: float = 600,
    chunk_bytes: int = CHUNK_BYTES,
) -> list:
    """Weak-scaling sweep over data-parallel group sizes, one child process
    per rank.

    Reference analog: the 1..64-thread JMH scaling table
    (``benchmark/reports/jtokkit.txt:1-29``). Each size n gets a corpus of
    ``n * mb_per_dev`` MB (weak scaling: per-rank work constant); throughput
    is the steady-state ``ShardedTokenizer.count_tokens_corpus`` (device
    compute + the all_reduce, no token fetch). Efficiency(n) =
    mbps(n) / (n * mbps(1)).

    ``device=None``: one NCCL rank per CUDA card, sizes up to the cards
    visible (raises without a card). ``device="cpu"``: gloo ranks of one
    thread each, sizes (1, 2, 4, 8) up to the CPU count, which measures the
    mechanics only; each row names its backend.
    """
    from .entry import check_cards, run_ranks

    dev = resolve_device(device)
    if sizes is None:
        n_all = torch.cuda.device_count() if dev.type == "cuda" else os.cpu_count() or 1
        grid = (1, 2, 4, 8, 16, 32) if dev.type == "cuda" else (1, 2, 4, 8)
        sizes = [n for n in grid if n <= n_all]
    code = ("import sys; from jtokkit_tpu_torch.bench import _scaling_rank; "
            "_scaling_rank(*sys.argv[1:])")
    rows = []
    base_mbps = None
    for n in sizes:
        check_cards(dev.type, n)
        out = run_ranks(code, n, [dev.type, mb_per_dev, encoding, flavor, passes,
                                  chunk_bytes], timeout)[0]
        got = json.loads(
            [line for line in out.splitlines() if line.startswith('{"mbps"')][-1]
        )
        mbps = got["mbps"]
        if base_mbps is None:
            base_mbps = mbps
        row_detail = {
            "n_devices": n,
            "backend": got["backend"],
            "device": got["device"],
            "corpus_mb": round(got["nbytes"] / 1e6, 2),
            "flavor": flavor,
            "tokens": int(got["tokens"]),
            "seconds": round(got["seconds"], 3),
            "efficiency": round(mbps / (n * base_mbps), 3),
            "scan_launches": got["scan_launches"],
        }
        if dev.type == "cuda":
            row_detail.update(_device_detail(dev))
        rows.append({
            "metric": f"{encoding} sharded count weak-scaling",
            "value": round(mbps, 2),
            "unit": "MB/s",
            "vs_baseline": round(
                mbps / BASELINE_MBPS.get(encoding, BASELINE_MBPS["cl100k_base"]), 2
            ),
            "detail": row_detail,
        })
    return rows


def _emit(row: dict) -> None:
    print(json.dumps(row), flush=True)


def main(argv=None) -> None:
    """The root ``bench.py`` over the port: prints ONE JSON line (possibly
    repeated, augmented, as the LAST line).

    The headline (cl100k_base english ``device`` at 32 MB by default) prints
    and flushes before any companion runs. Companions then run inside
    ``--budget`` seconds from process start; whatever finished (or failed,
    with its error) is attached as ``detail.companions`` and the augmented
    headline is printed again as the last line. ``--fast`` skips the
    companions. ``--all`` / ``--sweep`` / ``--scaling`` print one line per
    row and repeat the headline (or the last row) last.
    """
    p = argparse.ArgumentParser(prog="python -m jtokkit_tpu_torch.bench")
    p.add_argument("--mb", type=float, default=32)
    p.add_argument("--encoding", default="cl100k_base")
    p.add_argument("--mode", default="device", choices=MODES)
    p.add_argument("--flavor", default="english",
                   choices=["english", "mixed", "cjk"])
    p.add_argument("--smoke", action="store_true",
                   help="tiny corpus, quick sanity run")
    p.add_argument("--all", action="store_true",
                   help="full sweep: encodings x flavors x key modes")
    p.add_argument("--sweep", action="store_true",
                   help="native thread-scaling sweep (reference analog of "
                        "AbstractMultiThreadedBenchmark 1..64 threads)")
    p.add_argument("--scaling", action="store_true",
                   help="sharded weak-scaling sweep over group sizes, one "
                        "child process per rank (NCCL ranks on the cards, "
                        "gloo ranks with --device cpu)")
    p.add_argument("--threads", type=int, default=None,
                   help="thread count for native-mt")
    p.add_argument("--fast", action="store_true",
                   help="headline only: skip the companion sweep")
    p.add_argument("--budget", type=float, default=900.0,
                   help="wall-clock budget (s, from process start) for the "
                        "companion sweep; companions that would start past "
                        "it are skipped")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a torch.profiler chrome trace of the measured "
                        "passes into DIR")
    p.add_argument("--device", default=None,
                   help="torch device of the engines (default: the CUDA "
                        "card; 'cpu' runs the kernels' plain versions)")
    p.add_argument("--chunk-bytes", type=int, default=CHUNK_BYTES,
                   help="bytes per device chunk")
    args = p.parse_args(argv)
    on = dict(device=args.device, chunk_bytes=args.chunk_bytes)

    if args.scaling:
        rows = run_scaling(
            mb_per_dev=min(args.mb / 8, 2.0), encoding=args.encoding,
            flavor=args.flavor, **on,
        )
        for r in rows:
            _emit(r)
        _emit(rows[-1])
        return

    if args.sweep:
        rows = []
        for threads in (1, 2, 4, 8, 16):
            mode = "native" if threads == 1 else "native-mt"
            r = run(mb=args.mb, encoding=args.encoding, mode=mode,
                    flavor=args.flavor, passes=3, threads=threads, **on)
            r["detail"]["threads"] = threads
            r["detail"]["cpus"] = os.cpu_count()
            _emit(r)
            rows.append(r)
        _emit(rows[-1])
        return

    if args.all:
        rows = []
        for encoding in ("cl100k_base", "r50k_base", "p50k_base", "p50k_edit"):
            for flavor in ("english", "mixed", "cjk"):
                for mode in ("device", "device-count", "native", "native-mt"):
                    r = run(mb=args.mb, encoding=encoding, mode=mode,
                            flavor=flavor, passes=3, **on)
                    _emit(r)
                    rows.append(r)
        # headline repeated last for the single-line contract
        _emit(next(
            r for r in rows
            if r["detail"]["flavor"] == "english"
            and r["metric"].startswith("cl100k_base encode throughput (device,")
        ))
        return

    out = run(
        mb=1 if args.smoke else args.mb,
        encoding=args.encoding,
        mode=args.mode,
        flavor=args.flavor,
        passes=1 if args.smoke else 5,
        threads=args.threads,
        profile_dir=args.profile,
        **on,
    )
    # the headline is HONEST encode: every doc's token ids land in host RAM
    # each pass (device-count omits the token fetch; lists adds Python list
    # conversion). Recorded so the artifacts self-describe.
    out["detail"]["mode_semantics"] = (
        "device=encode with full token materialization to host RAM; "
        "device-count=token counting only (no token fetch; CUDA graph "
        "replays on a card); sharded=data-parallel encode over a "
        "torch.distributed group"
    )
    # HEADLINE FIRST: nothing that can time out runs before it
    _emit(out)

    default_headline = (
        args.mode == "device" and args.encoding == "cl100k_base"
        and args.flavor == "english" and not args.smoke
    )
    if not default_headline or args.fast:
        return
    # companion sweep, hard-budgeted: the whole picture in one artifact
    # (reference reports all four encodings, jtokkit.txt:26-29) — the
    # headline above is already safe no matter what happens here
    companions = []
    for enc, flavor, mode, mb in COMPANIONS:
        if args.budget - (time.time() - _T0) <= 0:
            companions.append({
                "metric": f"{enc} {mode} {flavor}",
                "skipped": "budget exhausted",
            })
            continue
        try:
            r = run(mb=mb or args.mb, encoding=enc, mode=mode,
                    flavor=flavor, passes=3, **on)
            companions.append({
                "metric": r["metric"], "value": r["value"],
                "unit": r["unit"], "vs_baseline": r["vs_baseline"],
                "flavor": flavor,
                "corpus_mb": r["detail"]["corpus_mb"],
            })
        except Exception as e:  # recorded in its entry; the run goes on
            companions.append({
                "metric": f"{enc} {mode} {flavor}", "error": repr(e)[:200],
            })
    out["detail"]["companions"] = companions
    out["detail"]["companion_budget_s"] = args.budget
    _emit(out)


if __name__ == "__main__":
    main()
