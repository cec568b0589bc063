"""The token fetch formats of the warmed encode, timed inside CUDA graphs.

    python -m jtokkit_tpu_torch.scripts.fetch_formats [--mb 16]

Over a warmed english plan (cl100k_base, 1 MiB chunks, the plan's encode
graphs captured and replayed), the ids that the last replay left in each
chunk's graph output are fetched three ways:

- ``p12``: the JAX engine's 12-bit plane (ids 0..4093 as 12-bit codes, two
  codes per 3 bytes; code 4094 marks an escape, whose id rides a side stream
  of low halves and 17th bits). The port ships no such format; its pack and
  unpack are kept here for this measurement only.
- ``lo``: the low halves and the 17th-bit plane
  (``DeviceEngine._slice_tokens``), the format the port ships.
- ``i32``: the int32 prefix as it is (no pack).

Each format's pack is captured as one CUDA graph per chunk (``i32`` has
none: its copy reads the tokens directly); a pass replays them and copies
every chunk's arrays into pinned host buffers. The device milliseconds of a
pass come from CUDA events around the replays and copies of all chunks,
queued behind a sleep kernel (no host launch gaps); the host milliseconds
are numpy's, from the pinned buffers to int32 ids, as
``DeviceEngine._consume_fetch`` does. Every format's ids must equal the
tokens. Needs a CUDA card, and raises without one.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict

import numpy as np
import torch

from ..engine.device import CorpusPlan, DeviceEngine, _Captured, _next_pow2
from ..ops import stage4
from ..ops.classify import take_clip
from .profile_gather import card_line, event_ms

FORMATS = ("p12", "lo", "i32")


def pack12(engine: DeviceEngine, tokens, pad: int, ecap: int):
    """The reference's 12-bit pack of ``tokens[:pad]`` with an escape side
    stream of ``ecap`` slots: (plane uint8[pad * 3 // 2], lo or None, hi or
    None)."""
    t = tokens[:pad]
    esc = t >= 4094
    c = torch.where(esc, 4094, t).reshape(-1, 2)
    c0, c1 = c[:, 0], c[:, 1]
    plane = torch.stack(
        [c0 & 0xFF, (c0 >> 8) | ((c1 & 0xF) << 4), c1 >> 4], dim=1
    ).to(torch.uint8).reshape(-1)
    if ecap == 0:
        return plane, None, None
    pos = stage4.masked_positions(esc, ecap, pad)
    vals = take_clip(t, torch.clamp(pos, max=pad - 1))
    return plane, engine._low_halves(vals), (
        engine._bit_plane(vals) if engine._fetch_wide else None
    )


def unpack12(plane, lo, hi, n_tokens: int, n_esc: int) -> np.ndarray:
    """int32 ids from a fetched 12-bit plane and its side stream (host
    tensors or numpy arrays). Escapes are read in stream order: the pad
    region of the tokens is zero, so no position past ``n_tokens`` reads as
    an escape."""
    b = np.asarray(plane).reshape(-1, 3).astype(np.uint16)
    c0 = b[:, 0] | ((b[:, 1] & 0xF) << 8)
    c1 = (b[:, 1] >> 4) | (b[:, 2] << 4)
    ids = np.stack([c0, c1], axis=1).reshape(-1)[:n_tokens].astype(np.int32)
    if n_esc:
        at = np.flatnonzero(ids == 4094)
        ids[at] = DeviceEngine._consume_fetch((lo, hi), n_esc)[: len(at)]
    return ids


class _Fetch(_Captured):
    """One chunk's fetch in one format: the pack's graph (None for
    ``i32``), its device outputs and the pinned buffers they go to."""

    def __init__(self, tokens, n_tokens: int, n_esc: int):
        super().__init__()
        self.tokens, self.n_tokens, self.n_esc = tokens, n_tokens, n_esc
        self.pad = min(_next_pow2(n_tokens, 8192), tokens.shape[0])
        self.ecap = _next_pow2(n_esc, 1024) if n_esc else 0
        self.host = None


def measure(engine: DeviceEngine, plan: CorpusPlan, passes: int = 5) -> Dict:
    """Time the three formats over ``plan``'s encode graphs (captured and
    replayed at least once). Returns, per format, the device ms of one pass
    over all chunks, the host ms of each of ``passes`` consumes, the bytes
    fetched and the graphs' pool bytes; and how many chunks the reference's
    rule (``ecap * 17 < pad * 4``) would send to the 12-bit plane."""
    if engine.device.type != "cuda" or not plan.encode_graphs:
        raise RuntimeError("fetch formats: needs a plan with encode graphs on a card")
    tokens = [g.out[0] for g in plan.encode_graphs]
    n_esc = [int((t[:n] >= 4094).sum()) for t, n in zip(tokens, plan.n_tokens)]
    want = [t[:n].cpu().numpy() for t, n in zip(tokens, plan.n_tokens)]
    out = {"chunks": len(tokens), "tokens": sum(plan.n_tokens)}
    for fmt in FORMATS:
        units = [_Fetch(t, n, e) for t, n, e in zip(tokens, plan.n_tokens, n_esc)]

        def pack(u, fmt=fmt):
            if fmt == "p12":
                return pack12(engine, u.tokens, u.pad, u.ecap)
            return engine._slice_tokens(u.tokens, u.pad)

        pool_bytes = 0
        if fmt == "i32":
            for u in units:
                u.out = (u.tokens[: u.pad],)
        else:
            _s, pool_bytes = engine._capture(
                lambda: [pack(u) for u in units], units, pack)
        for u in units:
            u.host = [None if a is None else torch.empty(
                a.shape, dtype=a.dtype, pin_memory=True) for a in u.out]

        def one_pass(units=units):
            for u in units:
                arrays = u.out if u.graph is None else engine._replay(u)
                for h, a in zip(u.host, arrays):
                    if a is not None:
                        h.copy_(a, non_blocking=True)

        device_ms = event_ms(one_pass, passes)
        host_ms = []
        for _ in range(passes):
            t0 = time.perf_counter()
            got = [
                unpack12(*u.host, u.n_tokens, u.n_esc) if fmt == "p12"
                else engine._consume_fetch(tuple(u.host), u.n_tokens) if fmt == "lo"
                else u.host[0][: u.n_tokens].numpy().copy()
                for u in units
            ]
            host_ms.append((time.perf_counter() - t0) * 1e3)
        if not all(np.array_equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"fetch format {fmt}: ids differ from the tokens")
        out[fmt] = {
            "device_ms": device_ms, "host_ms": host_ms, "pool_bytes": pool_bytes,
            "bytes": sum(h.numel() * h.element_size()
                         for u in units for h in u.host if h is not None),
        }
    out["rule_p12_chunks"] = sum(
        1 for u in units if u.ecap * 17 < u.pad * 4)
    return out


def main(argv=None) -> Dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--mb", type=float, default=16.0)
    args = parser.parse_args(argv)
    from .. import Encodings, EncodingType
    from ..utils import corpus

    enc = Encodings.new_default_encoding_registry().get_encoding(EncodingType.CL100K_BASE)
    engine = DeviceEngine.from_oracle(enc.oracle, native_long=False)
    docs = corpus.generate(args.mb, flavor="english")
    plan = engine.preload_corpus(docs)
    engine.count_tokens_corpus(docs, plan=plan)
    for _ in range(4):  # caches the counts, captures the graphs, replays
        engine.encode_ordinary_batch_arrays(None, plan=plan)
    row = measure(engine, plan)
    row["card"] = card_line()
    for fmt in FORMATS:
        r = row[fmt]
        print(f"{fmt}: {r['device_ms']:.3f} device ms a pass, host "
              f"{min(r['host_ms']):.2f} ms, {r['bytes']} bytes [{row['card']}]")
    print(json.dumps(row))
    return row


if __name__ == "__main__":
    main()
