#!/usr/bin/env python3
"""Smoke run of the PyTorch port (jtokkit_tpu_torch) on one CUDA card.

    python3 chip_smoke.py                 # the run described below
    python3 chip_smoke.py --profile [DIR] # also a torch.profiler window over
                                          # one 2 MB english encode (device
                                          # time by kernel), its table also
                                          # written to DIR when given

Phases (each raises on failure, and then no result line is printed):

1. Card: requires CUDA; prints nvidia-smi's name and power limit.
2. Build: compiles the scan kernel (jtokkit_tpu_torch/csrc/scan.cu) from
   the checkout with nvcc and prints the build time.
3. Kernel against its plain PyTorch version on the card, exact int32
   equality, at the main path's shapes and ragged ones; prints kernel,
   plain, library (torch.cummax / torch.cumsum per leaf) and bound times.
4. Main path at full size: cl100k_base through the public registry on the
   default device; encode_ordinary_batch and count_tokens_batch over 16 MB
   english, 2 MB mixed and 1 MB cjk (1 MiB chunks). Tokens are held against
   the host oracle on a >= 1 MB sample of each corpus and on the four
   conformance CSVs; counts against token lengths; the scan counters show
   5 kernel launches per cl100k Stage A run and no plain-version call.
5. One JSON line of kernel numbers, then the last line
   {"ok": true, "device": {...}}.

Imports nothing of JAX or jtokkit_tpu.
"""

from __future__ import annotations

import argparse
import ast
import csv
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
REPLACES = "jtokkit_tpu/ops/pallas_scan.py:144"  # _scan_stacked


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def device_ms(fn, iters: int) -> float:
    """Device time of one call of ``fn``: CUDA events around ``iters``
    back-to-back calls, queued behind a sleep kernel so host launch time
    does not leave gaps."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # ~25 ms of queue while the host enqueues
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def make_leaves(kinds, n, gen):
    """Leaves shaped like Stage A's: sparse positions (else -1) for max and
    last, 0/1 for add."""
    import torch

    idx = torch.arange(n, dtype=torch.int32, device="cuda")
    out = []
    for k in kinds:
        if k == "add":
            out.append(torch.randint(0, 2, (n,), generator=gen, device="cuda",
                                     dtype=torch.int32))
        else:
            keep = torch.rand(n, generator=gen, device="cuda") < 0.1
            out.append(torch.where(keep, idx, -1))
    return out


def phase_kernel(scan):
    import numpy as np
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    main_shapes = [
        # (kinds, n, reverse): Stage A's scans at a 1 MiB chunk
        (("max", "max", "max"), 1 << 20, False),   # boundary scan 1, ascii
        (("max", "max", "add"), 1 << 20, False),   # boundary scan 1, unicode
        (("max", "max", "max"), 1 << 20, False),   # boundary scan 2, unicode
        (("last", "last", "last"), 1 << 20, True),  # boundary scan 3, ascii
        (("last",) * 4, 1 << 20, True),            # boundary scan 3, unicode
        (("max", "max"), 1 << 18, False),          # masked_rows stitch
        (("max", "max"), 1 << 15, False),          # masked_positions, ascii
        (("max", "max"), 1 << 17, False),          # masked_positions, unicode
    ]
    max_err = 0
    rows = []
    for kinds, n, reverse in main_shapes:
        leaves = make_leaves(kinds, n, gen)
        got = scan.scan_leaves_cuda(leaves, kinds, reverse=reverse)
        want = scan.scan_leaves_plain(leaves, kinds, reverse=reverse)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            err = int((g.long() - w.long()).abs().max())
            max_err = max(max_err, err)
            if err:
                raise AssertionError(f"kernel != plain at {kinds} n={n}")
        ms = device_ms(lambda: scan.scan_leaves_cuda(leaves, kinds, reverse=reverse), 200)
        plain_ms = device_ms(lambda: scan.scan_leaves_plain(leaves, kinds, reverse=reverse), 50)
        library_ms = None
        if "last" not in kinds:
            def library():
                for x, k in zip(leaves, kinds):
                    if k == "max":
                        torch.cummax(x, 0)
                    else:
                        torch.cumsum(x, 0, dtype=torch.int32)
            library_ms = device_ms(library, 50)
        bound_ms = 2 * len(kinds) * n * 4 / HBM_BYTES_PER_S * 1e3
        rows.append({
            "kinds": list(kinds), "n": n, "reverse": reverse, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
        })
        lib = "null" if library_ms is None else f"{library_ms:.4f}"
        log(f"scan {','.join(kinds):<16} n={n:<8} rev={int(reverse)}  kernel "
            f"{ms:.4f} ms  plain {plain_ms:.4f} ms  library {lib} ms  "
            f"bound {bound_ms:.4f} ms  ({bound_ms / ms:.0%} of bound)")

    # ragged lengths, every kind, both directions
    for n in (1, 127, 129, 4097, 1_000_003):
        for reverse in (False, True):
            for kinds in (("max", "last", "add"), ("add", "max", "last", "last")):
                leaves = make_leaves(kinds, n, gen)
                got = scan.scan_leaves_cuda(leaves, kinds, reverse=reverse)
                want = scan.scan_leaves_plain(leaves, kinds, reverse=reverse)
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    if not torch.equal(g, w):
                        raise AssertionError(f"kernel != plain at {kinds} n={n} rev={reverse}")
    # an add leaf whose sum wraps past int32
    big = torch.full((1 << 20,), 1 << 30, dtype=torch.int32, device="cuda")
    got = scan.scan_leaves_cuda([big], ["add"])[0].cpu().numpy()
    want = (np.arange(1, (1 << 20) + 1, dtype=np.int64) << 30).astype(np.uint64)
    want = (want & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    if not np.array_equal(got, want):
        raise AssertionError("int32 add does not wrap")
    log(f"kernel == plain version on every shape (max_abs_err {max_err})")
    return rows, max_err


def load_conformance(name: str):
    path = os.path.join(ROOT, "tests", "data", f"{name}_encodings.csv")
    with open(path, newline="") as f:
        return [
            (r["input"], ast.literal_eval(r["output"]))
            for r in csv.DictReader(f, skipinitialspace=True)
        ]


def sample(docs, mb: float):
    out, size = [], 0
    for d in docs:
        if size >= mb * 1e6:
            break
        out.append(d)
        size += len(d.encode("utf-8"))
    if size < mb * 1e6:
        raise AssertionError("corpus sample smaller than asked")
    return out


def phase_main_path(card: str):
    import torch

    from jtokkit_tpu_torch import Encodings, EncodingType
    from jtokkit_tpu_torch.ops import merge, scan
    from jtokkit_tpu_torch.utils import corpus

    t0 = time.time()
    registry = Encodings.new_default_encoding_registry()
    enc = registry.get_encoding(EncodingType.CL100K_BASE)
    engine = enc.device_engine()
    if engine.device.type != "cuda" or engine.chunk_bytes != 1 << 20:
        raise AssertionError(f"engine on {engine.device}, chunk {engine.chunk_bytes}")
    log(f"registry + cl100k tables on {engine.device}: {time.time() - t0:.1f} s")

    corpora = {
        "english": corpus.generate(16, flavor="english"),
        "mixed": corpus.generate(2, flavor="mixed"),
        "cjk": corpus.generate(1, flavor="cjk"),
    }
    # warm-up (allocator, library handles), not counted
    enc.encode_ordinary_batch(corpora["english"][:16])
    enc.count_tokens_batch(corpora["english"][:16])
    torch.cuda.synchronize()

    scan.KERNEL_LAUNCHES = 0
    scan.PLAIN_CALLS = 0
    merge.MERGE_ROUNDS = 0
    runs0, host0 = engine.stage_a_runs, engine.host_chunks
    results = {}
    for name, docs in corpora.items():
        mb = sum(len(d.encode("utf-8")) for d in docs) / 1e6
        t = time.time()
        tokens = enc.encode_ordinary_batch(docs)
        enc_s = time.time() - t
        t = time.time()
        counts = enc.count_tokens_batch(docs)
        cnt_s = time.time() - t
        results[name] = (docs, tokens, counts, mb, enc_s, cnt_s)
    launches, plain = scan.KERNEL_LAUNCHES, scan.PLAIN_CALLS
    rounds = merge.MERGE_ROUNDS
    runs = engine.stage_a_runs - runs0
    host_chunks = engine.host_chunks - host0

    log(f"main path: {runs} Stage A runs, {launches} scan kernel launches, "
        f"{plain} plain scan calls, {rounds} merge rounds, "
        f"{host_chunks} host chunks")
    if launches != 5 * runs or runs == 0:
        raise AssertionError(f"{launches} launches for {runs} cl100k Stage A runs")
    if plain != 0:
        raise AssertionError(f"{plain} scans took the plain version")
    if host_chunks != 0:
        raise AssertionError(f"{host_chunks} chunks went to the host oracle")

    oracle = enc.oracle
    for name, (docs, tokens, counts, mb, enc_s, cnt_s) in results.items():
        if counts != [len(t) for t in tokens]:
            raise AssertionError(f"{name}: counts differ from token lengths")
        checked = sample(docs, 1.0)
        for d, got in zip(checked, tokens):
            if got != oracle.encode_ordinary(d)[0]:
                raise AssertionError(f"{name}: tokens differ from the oracle")
        n_tok = sum(len(t) for t in tokens)
        log(f"{name}: {mb:.2f} MB, {len(docs)} docs, {n_tok} tokens; encode "
            f"{mb / enc_s:.2f} MB/s, count {mb / cnt_s:.2f} MB/s "
            f"({len(checked)} docs checked against the oracle) [{card}]")

    for name in ("r50k_base", "p50k_base", "p50k_edit", "cl100k_base"):
        rows = load_conformance(name)
        e = registry.get_encoding(name)
        got = e.encode_ordinary_batch([r[0] for r in rows])
        for (text, want), g in zip(rows, got):
            if g != want or g != e.oracle.encode_ordinary(text)[0]:
                raise AssertionError(f"{name}: conformance row {text!r} differs")
        if e.count_tokens_batch([r[0] for r in rows]) != [len(g) for g in got]:
            raise AssertionError(f"{name}: conformance counts differ")
        log(f"{name}: {len(rows)} conformance rows equal on the card")
    return launches, {k: v[3:] for k, v in results.items()}


def phase_profile(card: str, out_dir: str):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from jtokkit_tpu_torch import Encodings, EncodingType
    from jtokkit_tpu_torch.utils import corpus

    enc = Encodings.new_lazy_encoding_registry().get_encoding(EncodingType.CL100K_BASE)
    docs = corpus.generate(2, seed=1, flavor="english")
    enc.encode_ordinary_batch(docs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.time()
        enc.encode_ordinary_batch(docs)
        torch.cuda.synchronize()
        wall = time.time() - t
    events = prof.key_averages()
    table = events.table(sort_by="self_cuda_time_total", row_limit=60)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "profile_english_2mb.txt"), "w") as f:
            f.write(f"{card}\nwall {wall:.4f} s\n{table}\n")
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    kernel_us = sum(e.self_device_time_total for e in device)
    scan_us = sum(
        e.self_device_time_total for e in device
        if "at::native" not in e.key
        and any(k in e.key for k in ("reduce_kernel", "carry_kernel", "scan_kernel"))
    )
    log(f"profile (2 MB english encode): wall {wall * 1e3:.1f} ms, device "
        f"kernels {kernel_us / 1e3:.1f} ms ({kernel_us / 1e6 / wall:.1%} busy), "
        f"scan kernel {scan_us / 1e3:.3f} ms, "
        f"{sum(e.count for e in device)} kernel launches")
    log(table)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", nargs="?", const="", default=None,
                        metavar="DIR", help="add a profiler window")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.time()
    sys.path.insert(0, ROOT)
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    from jtokkit_tpu_torch.ops import scan

    t = time.time()
    scan.build()
    log(f"build: scan kernel in {time.time() - t:.1f} s ({scan.library_path()})")
    for line in scan.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            log("  " + line.strip())

    rows, max_err = phase_kernel(scan)
    launches, rates = phase_main_path(card)
    if args.profile is not None:
        phase_profile(card, args.profile)

    head = rows[1]  # max,max,add at n = 2^20: the largest scan on the path
    kernels = [{
        "name": "scan_leaves",
        "route": "cuda",
        "source": "jtokkit_tpu_torch/csrc/scan.cu",
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": max_err,
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": "bytes",
        "library_ms": head["library_ms"],
        "shape": {"kinds": head["kinds"], "n": head["n"]},
        "shapes": rows,
    }]
    summary = {name: {"mb": mb, "encode_mb_s": mb / e, "count_mb_s": mb / c}
               for name, (mb, e, c) in rates.items()}
    log(json.dumps({"main_path": summary, "card": card,
                    "seconds": time.time() - t_start}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
