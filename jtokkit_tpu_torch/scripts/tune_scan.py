"""Variants of the scan kernel timed beside each other on the card.

    python -m jtokkit_tpu_torch.scripts.tune_scan [threads,items,order[,nolook][,indexed] ...]

The shipped ``csrc/scan.cu`` has one tile shape and one memory order for its
status words. This script shows what the alternatives cost: it writes copies
of the source with the constants replaced (threads per block, scan positions
per thread, ``relaxed`` or ``acqrel`` status accesses, and optionally
``nolook``, the look-back taken out, which gives wrong results and is for
timing only, or ``indexed``, the thread's values indexed by the runtime
direction instead of selected, which sends them to local memory),
builds them all at once into ``_build/``, checks each against the plain
version and times it at the main path's shapes. With no arguments it runs
the set that the design was chosen from; the first line is the shipped
kernel. Every line names the card and its power limit; two variants are
comparable only within one run.
"""

from __future__ import annotations

import ctypes
import os
import sys
from typing import List, Sequence

import torch

from ..engine.device import resolve_device
from ..ops import _build, scan
from .profile_gather import card_line, event_ms

DEFAULT = ("256,32,relaxed", "256,32,acqrel", "256,32,relaxed,nolook",
           "256,32,relaxed,indexed", "256,16,relaxed", "256,16,acqrel",
           "512,16,relaxed", "128,32,relaxed", "256,8,relaxed")
SHAPES = (
    (("max", "max", "add"), 1 << 20, False),
    (("last",) * 4, 1 << 20, True),
    (("max",), 1 << 24, False),
    (("max",) * 4, 1 << 24, False),
    (("max", "max"), 1 << 15, False),
    (("max",), 1 << 13, False),
)
HBM_BYTES_PER_S = 3.35e12


def variant_source(text: str, threads: int, items: int, order: str,
                   flags: Sequence[str] = ()) -> str:
    """``csrc/scan.cu``'s text with the variant's constants put in."""
    def swap(old: str, new: str) -> None:
        nonlocal text
        if old not in text:
            raise RuntimeError(f"csrc/scan.cu no longer holds {old!r}")
        text = text.replace(old, new)

    swap("constexpr int kThreads = 256;", f"constexpr int kThreads = {threads};")
    swap("constexpr int kItems = 32; ", f"constexpr int kItems = {items}; ")
    if order == "acqrel":
        swap("st.relaxed.gpu.global.u64", "st.release.gpu.global.u64")
        swap("ld.relaxed.gpu.global.u64", "ld.acquire.gpu.global.u64")
    elif order != "relaxed":
        raise ValueError(f"unknown memory order {order!r}")
    if set(flags) - {"nolook", "indexed"}:
        raise ValueError(f"unknown flags {flags!r}")
    if "nolook" in flags:
        swap("excl = look_back<K>(status, tile, epoch, lane);", "excl = ident<K>();")
    if "indexed" in flags:
        for a, b in ((3, 0), (2, 1), (1, 2), (0, 3)):
            swap(f"reverse ? vals[4 * m + {a}] : vals[4 * m + {b}];",
                 f"vals[4 * m + (reverse ? {a} : {b})];")
    return text


def _leaves(kinds, n, gen, dev):
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    out = []
    for k in kinds:
        if k == "add":
            out.append(torch.randint(0, 2, (n,), generator=gen, device=dev,
                                     dtype=torch.int32))
        else:
            keep = torch.rand(n, generator=gen, device=dev) < 0.1
            out.append(torch.where(keep, idx, -1))
    return out


def main(specs: List[str]) -> List[dict]:
    dev = resolve_device(None)
    card = card_line()
    with open(scan.LIBRARY.source) as f:
        base = f.read()
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    libs = []
    for i, spec in enumerate(specs):
        parts = spec.split(",")
        threads, items, order = int(parts[0]), int(parts[1]), parts[2]
        path = os.path.join(_build.BUILD_DIR, f"scan_variant_{i}.cu")
        with open(path, "w") as f:
            f.write(variant_source(base, threads, items, order, parts[3:]))
        lib = _build.KernelLibrary("scan", lambda _lib: None)
        lib.source = path
        libs.append(lib)
    _build.build_all(libs)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    data = [(k, n, r, _leaves(k, n, gen, dev)) for k, n, r in SHAPES]
    want = [scan.scan_leaves_plain(lv, k, reverse=r) for k, n, r, lv in data]
    stream = torch.cuda.current_stream(dev).cuda_stream
    index = _build.cuda_device_index(dev)
    rows = []
    for spec, lib in zip(specs, libs):
        handle = ctypes.CDLL(lib.build())
        scan.declare_functions(handle)
        tile = handle.jt_scan_tile()
        regs = [ln.split(":")[-1].strip() for ln in lib.build_log.splitlines()
                if "Used" in ln or "stack" in ln]
        print(f"== {spec}: tile {tile}; {'; '.join(regs)} [{card}]", flush=True)
        for (kinds, n, rev, leaves), w in zip(data, want):
            L = len(kinds)
            out = scan.empty_rows(L, n, dev)
            words = scan.HEADER_WORDS + L * (-(-n // tile))
            scratch = torch.zeros(words, dtype=torch.int64, device=dev)
            code = sum(scan.KINDS[k] << (2 * j) for j, k in enumerate(kinds))
            pad = [None] * (scan.MAX_LEAVES - L)
            args = ([x.data_ptr() for x in leaves] + pad
                    + [x.data_ptr() for x in out] + pad
                    + [L, n, code, int(rev), scratch.data_ptr(), words, index, stream])

            def launch():
                rc = handle.jt_scan_leaves(*args)
                if rc != 0:
                    raise RuntimeError(f"variant {spec}: CUDA error {rc}")

            launch()
            torch.cuda.synchronize()
            equal = all(torch.equal(g, x) for g, x in zip(out, w))
            ms = event_ms(launch, 200)
            bound = 2 * L * n * 4 / HBM_BYTES_PER_S * 1e3
            rows.append({"variant": spec, "kinds": list(kinds), "n": n,
                         "reverse": rev, "ms": ms, "bound_ms": bound,
                         "equal": equal, "card": card})
            print(f"  {','.join(kinds):<20} n=2^{n.bit_length() - 1:<3} rev={int(rev)}  "
                  f"{ms:.4f} ms  ({bound / ms:.0%} of bound)  "
                  f"{'== plain' if equal else '!= plain'}", flush=True)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:] or list(DEFAULT))
