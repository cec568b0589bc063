"""Host time of the chunk packer against ``str.encode`` on the benchmark's
batches of each configuration.

For each configuration of ``tokbench/`` (books, web, culturax) this builds
a small ring of its 4 MiB batches (``tokbench/ring.py`` at ``--seed``, at
least ``--ring-mib`` MiB) and times, per batch, in turns over the ring's
batches (so that a batch is not in the cache from its last turn):

- ``encode_ms``: ``t.encode("utf-8")`` of every document, the least that
  any packing in Python pays;
- ``pack_ms``: :class:`jtokkit_tpu_torch.pack.ChunkPacker` over the batch
  into fresh blocks from PyTorch's allocator (pinned on a CUDA machine, as
  the engine's un-planned call packs them), every chunk of it, no upload.

Prints one JSON line a configuration: the medians over every turn, the
batch's documents, bytes and documents in non-ASCII storage (``wide``), the
machine's CPU and whether the blocks were pinned. Nothing here uses the
card beyond its pinned host memory.

Run from the repository's root (it imports ``tokbench``):
``python -m jtokkit_tpu_torch.scripts.time_pack [--seed 7] [--turns 5]``
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import statistics
import time

import torch

from .. import pack
from ..engine.device import _DOC_SIZES, CHUNK_BYTES, flat_sizes

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIGS = {"cl100k-books": "encode", "r50k-web": "encode",
           "cl100k-culturax": "culturax-encode"}


def cpu_name() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor()


def batches(config_name: str, seed: int, ring_mib: int):
    from tokbench import ring

    root = os.path.join(REPO, "tokbench")
    with open(os.path.join(root, "configs", f"{config_name}.json")) as f:
        config = json.load(f)
    with open(os.path.join(root, "traffic", f"{CONFIGS[config_name]}.json")) as f:
        traffic = json.load(f)
    traffic.update(ring_min_batches=4, ring_min_bytes=ring_mib << 20)
    return ring.build_ring(config, traffic, seed, root).batches


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--turns", type=int, default=5)
    ap.add_argument("--ring-mib", type=int, default=32)
    args = ap.parse_args(argv)
    pin = torch.cuda.is_available()
    pack.build()
    for name in CONFIGS:
        ring_batches = batches(name, args.seed, args.ring_mib)
        enc, packed, wide = [], [], []
        for _turn in range(args.turns):
            for batch in ring_batches:
                t = time.perf_counter()
                for d in batch:
                    d.encode("utf-8")
                enc.append(time.perf_counter() - t)
                t = time.perf_counter()
                packer = pack.ChunkPacker(batch, CHUNK_BYTES, flat_sizes(CHUNK_BYTES),
                                          _DOC_SIZES, pin=pin)
                for _chunk in packer:
                    pass
                packed.append(time.perf_counter() - t)
                wide.append(packer.wide_docs)
        n_bytes = [sum(len(d.encode("utf-8")) for d in b) for b in ring_batches]
        print(json.dumps({
            "config": name, "batches": len(ring_batches), "turns": args.turns,
            "docs_median": statistics.median(len(b) for b in ring_batches),
            "bytes_median": statistics.median(n_bytes),
            "wide_median": statistics.median(wide),
            "encode_ms": round(1e3 * statistics.median(enc), 4),
            "pack_ms": round(1e3 * statistics.median(packed), 4),
            "pack_ms_max": round(1e3 * max(packed), 4),
            "pinned": pin, "cpu": cpu_name(), "cores": os.cpu_count(),
        }), flush=True)


if __name__ == "__main__":
    main()
