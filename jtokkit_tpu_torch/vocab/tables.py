"""Packed vocabulary tables for the device engine.

The reference engine looks up candidate merges by *byte content* in a
``HashMap<byte[], Integer>`` (reference ``M/GptBytePairEncoding.java:285-300``).
Variable-length byte-string hashing is hostile to a fixed-shape vector
machine, so the device engine uses an equivalent integer formulation:

Every span the merge loop ever holds is itself a vocabulary token (spans
start as single bytes — all 256 single bytes are vocab tokens in every
tiktoken vocabulary — and every merge produces a vocab token by the lookup
condition). Therefore the byte-content query "is concat(span_i, span_j) in
the vocab?" is exactly the integer query "(id_i, id_j) ∈ PAIR_TABLE", where
PAIR_TABLE enumerates ALL 2-token compositions of every vocab token:

    for every token w with |bytes(w)| ≥ 2:
        for every split bytes(w) = u_bytes + v_bytes with u, v ∈ vocab:
            PAIR_TABLE[(id(u), id(v))] = id(w)      # rank(w) == id(w)

This is complete (not just canonical BPE splits), so it reproduces the
byte-content lookup bit-exactly. The table is built once on host and stored
as an open-addressing hash (linear probing) in three int32 arrays, suitable
for HBM-resident gathers inside the merge kernel.

Packed artifacts are cached as ``.npz`` keyed by the vocab file's size+mtime.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

# Multiplicative hashing constants (32-bit golden-ratio style). The device
# side reproduces these exact functions with uint32 wraparound arithmetic.
# Two independent hash functions for the cuckoo tables: lookups are always
# exactly two gathers, no probe loop — ideal for a vector machine.
_H1_A, _H1_B, _H1_C = np.uint32(0x9E3779B1), np.uint32(0x85EBCA77), np.uint32(0x2C1B3C6D)
_H2_A, _H2_B, _H2_C = np.uint32(0xC2B2AE3D), np.uint32(0x27D4EB2F), np.uint32(0x165667B1)

EMPTY = np.int32(-1)

# Length-threshold count for the merge-safety masks: bit l-1 of the L mask
# of pair entry (u, v) says "no pair (X, v-consumer...)" — see
# build_safety_masks. 16 L bits + 16 R bits fill one int32 per entry.
SAFE_LMAX = 16


def _mix(u, v, a, b, c, mask):
    h = (u.astype(np.uint32) * a) ^ (v.astype(np.uint32) * b)
    h ^= h >> np.uint32(15)
    h *= c
    h ^= h >> np.uint32(13)
    return (h & np.uint32(mask)).astype(np.int32)


def pair_hash1(u: np.ndarray, v: np.ndarray, mask: int) -> np.ndarray:
    return _mix(u, v, _H1_A, _H1_B, _H1_C, mask)


def pair_hash2(u: np.ndarray, v: np.ndarray, mask: int) -> np.ndarray:
    return _mix(u, v, _H2_A, _H2_B, _H2_C, mask)


@dataclass
class PackedVocabulary:
    """Device-ready integer tables for one encoding."""

    name: str
    n_tokens: int
    max_token_len: int
    # token id -> bytes (decode gather): pool + offsets
    token_offsets: np.ndarray  # int32[n_tokens + 1]
    token_bytes: np.ndarray  # uint8[total_bytes]
    token_lengths: np.ndarray  # int32[n_tokens]
    # single byte -> token id
    byte_to_id: np.ndarray  # int32[256]
    # direct byte-pair seed table: (b0 << 8 | b1) -> merged id or -1.
    # All initial merge-loop lookups are pairs of single-byte tokens, so the
    # seeding pass needs exactly one gather into this 64K table.
    byte_pair_id: np.ndarray  # int32[65536]
    # cuckoo pair tables: (u, v) -> merged id; packed key = u*n_tokens-ish is
    # avoided — keys stored as separate u/v arrays. EMPTY slots are -1.
    cuckoo_u: np.ndarray  # int32[2, table_size]
    cuckoo_v: np.ndarray  # int32[2, table_size]
    cuckoo_id: np.ndarray  # int32[2, table_size]
    table_mask: int
    n_pairs: int
    # word-table: whole-token direct hits for tokens of 1..16 bytes (99%+ of
    # every tiktoken vocabulary — the reference direct-hits ANY whole-piece
    # token, M/GptBytePairEncoding.java:81-83), keyed on the four
    # little-endian int32 words of the zero-padded bytes plus the length.
    # Exact (full 4-word + length compare in the slot).
    word_w0: np.ndarray  # int32[2, word_size]
    word_w1: np.ndarray  # int32[2, word_size]
    word_w2: np.ndarray  # int32[2, word_size]
    word_w3: np.ndarray  # int32[2, word_size]
    word_len: np.ndarray  # int32[2, word_size]  (-1 empty)
    word_id: np.ndarray  # int32[2, word_size]
    word_mask: int
    # merge-safety data for the exact batched device merge (ops/merge.py):
    # cuckoo_safe[t][s] packs, for the pair entry (u, v -> id) in that slot,
    #   bits 0..15:  (id <  minR_gt[u][l]) for l = 1..16   [left threats]
    #   bits 16..31: (id <= minL_gt[v][l]) for l = 1..16   [right threats]
    # where minR_gt[t][l] = min id over pair entries (X, t) with len(X) > l
    # and minL_gt[t][l] = min id over entries (t, Y) with len(Y) > l.
    cuckoo_safe: np.ndarray  # int32[2, table_size]
    # byte-pair seed table with round-1 safety bits:
    # id (bits 0..17) | safeL@l=1 << 18 | safeR@l=1 << 19, or -1 when the
    # byte pair is not mergeable.
    byte_pair_seed: np.ndarray  # int32[65536]

    def lookup_pairs(self, u: np.ndarray, v: np.ndarray) -> np.ndarray:
        """Host (numpy) pair lookup, mirroring the device's two gathers.

        Returns merged token id, or -1 where (u, v) is not mergeable.
        Inputs may contain -1 (invalid span), which never matches.
        """
        u = np.asarray(u, dtype=np.int32)
        v = np.asarray(v, dtype=np.int32)
        s1 = pair_hash1(u, v, self.table_mask)
        s2 = pair_hash2(u, v, self.table_mask)
        hit1 = (self.cuckoo_u[0][s1] == u) & (self.cuckoo_v[0][s1] == v)
        hit2 = (self.cuckoo_u[1][s2] == u) & (self.cuckoo_v[1][s2] == v)
        out = np.where(hit1, self.cuckoo_id[0][s1], EMPTY)
        return np.where(hit2, self.cuckoo_id[1][s2], out)


def _enumerate_pairs(ranks: Dict[bytes, int]):
    """All 2-token compositions of every vocab token."""
    pairs_u, pairs_v, pairs_id = [], [], []
    for token, rank in ranks.items():
        if len(token) < 2:
            continue
        for s in range(1, len(token)):
            left = ranks.get(token[:s])
            if left is None:
                continue
            right = ranks.get(token[s:])
            if right is None:
                continue
            pairs_u.append(left)
            pairs_v.append(right)
            pairs_id.append(rank)
    return (
        np.asarray(pairs_u, dtype=np.int32),
        np.asarray(pairs_v, dtype=np.int32),
        np.asarray(pairs_id, dtype=np.int32),
    )


def _build_cuckoo(u_arr, v_arr, id_arr):
    """Two-table cuckoo hash: every lookup is exactly two gathers."""
    n_pairs = len(u_arr)
    size = 1
    while size < int(n_pairs * 1.1) + 1:
        size *= 2
    rng = np.random.RandomState(0)
    for _attempt in range(8):
        mask = size - 1
        cu = np.full((2, size), EMPTY, dtype=np.int32)
        cv = np.full((2, size), EMPTY, dtype=np.int32)
        cid = np.full((2, size), EMPTY, dtype=np.int32)
        h1 = pair_hash1(u_arr, v_arr, mask)
        h2 = pair_hash2(u_arr, v_arr, mask)
        ok = True
        for i in range(n_pairs):
            t, u, v, w = 0, int(u_arr[i]), int(v_arr[i]), int(id_arr[i])
            s = int(h1[i])
            for _kick in range(500):
                if cu[t, s] == EMPTY:
                    cu[t, s], cv[t, s], cid[t, s] = u, v, w
                    break
                # evict occupant, move it to its alternate table
                u, cu[t, s] = int(cu[t, s]), u
                v, cv[t, s] = int(cv[t, s]), v
                w, cid[t, s] = int(cid[t, s]), w
                t = 1 - t
                ua, va = np.asarray([u], np.int32), np.asarray([v], np.int32)
                s = int((pair_hash1 if t == 0 else pair_hash2)(ua, va, mask)[0])
            else:
                ok = False
                break
        if ok:
            return cu, cv, cid, mask
        size *= 2  # rare: grow and retry
    raise RuntimeError("cuckoo build failed to converge")


def _build_threat_tables(u_arr, v_arr, id_arr, lengths, n_tokens):
    """minR_gt / minL_gt over the all-compositions pair table.

    minR_gt[t][l] = min id over entries (X, t) with len(X) > l: the best
    rank any FUTURE left-neighbor pair consuming t can ever have, given the
    current left neighbor is at most l bytes (a future consumer strictly
    contains the current neighbor as a suffix). minL_gt is the mirror for
    right threats. l is clamped to SAFE_LMAX (conservative).
    """
    big = np.int32(0x7FFFFFFF)
    minR = np.full((n_tokens, SAFE_LMAX + 1), big, dtype=np.int32)
    minL = np.full((n_tokens, SAFE_LMAX + 1), big, dtype=np.int32)
    len_u = lengths[u_arr]
    len_v = lengths[v_arr]
    for l in range(1, SAFE_LMAX + 1):
        m = len_u > l
        if m.any():
            np.minimum.at(minR[:, l], v_arr[m], id_arr[m])
        m = len_v > l
        if m.any():
            np.minimum.at(minL[:, l], u_arr[m], id_arr[m])
    return minL, minR


def _safety_masks(u, v, ids, minL, minR):
    """Per-entry packed safety masks for slot arrays (vectorized).

    Empty slots (ids < 0) get mask 0.
    """
    uc = np.clip(u, 0, minR.shape[0] - 1)
    vc = np.clip(v, 0, minL.shape[0] - 1)
    out = np.zeros(u.shape, dtype=np.int64)
    for l in range(1, SAFE_LMAX + 1):
        out |= (ids < minR[uc, l]).astype(np.int64) << (l - 1)
        out |= (ids <= minL[vc, l]).astype(np.int64) << (16 + l - 1)
    out = np.where(ids >= 0, out, 0)
    return out.astype(np.uint32).view(np.int32)


_LEN_MIX = np.uint32(0x01000193)


_W2_MIX = np.uint32(0x7FEB352D)
_W3_MIX = np.uint32(0x846CA68B)


def word_key(w0, w1, w2, w3, length):
    """Hash key halves for the 16-byte word-table: the upper words and the
    length fold into the two halves so different strings hash apart;
    exactness comes from comparing (w0..w3, len) in the slot, not from the
    hash. The device probe reproduces this exactly with uint32 wraparound
    (jtokkit_tpu_torch.ops.stage4)."""
    u = w0.astype(np.uint32) ^ (w2.astype(np.uint32) * _W2_MIX)
    v = (
        w1.astype(np.uint32)
        ^ (length.astype(np.uint32) * _LEN_MIX)
        ^ (w3.astype(np.uint32) * _W3_MIX)
    )
    return u, v


def _build_word_table(ranks: Dict[bytes, int]):
    """Cuckoo table of whole tokens with 1..16 bytes, exact-match keyed on
    (padded words 0..3, byte length). Covers 99%+ of every tiktoken vocab,
    so nearly every whole-token piece resolves without a merge."""
    w0s, w1s, w2s, w3s, lens, ids = [], [], [], [], [], []
    for token, rank in ranks.items():
        n = len(token)
        if not (1 <= n <= 16):
            continue
        padded = token + b"\x00" * (16 - n)
        w0s.append(int.from_bytes(padded[:4], "little"))
        w1s.append(int.from_bytes(padded[4:8], "little"))
        w2s.append(int.from_bytes(padded[8:12], "little"))
        w3s.append(int.from_bytes(padded[12:], "little"))
        lens.append(n)
        ids.append(rank)
    n_entries = len(w0s)
    w0 = np.asarray(w0s, dtype=np.uint32).astype(np.int32)
    w1 = np.asarray(w1s, dtype=np.uint32).astype(np.int32)
    w2 = np.asarray(w2s, dtype=np.uint32).astype(np.int32)
    w3 = np.asarray(w3s, dtype=np.uint32).astype(np.int32)
    ln = np.asarray(lens, dtype=np.int32)
    wid = np.asarray(ids, dtype=np.int32)

    size = 1
    while size < int(n_entries * 1.2) + 2:
        size *= 2
    for _attempt in range(8):
        mask = size - 1
        slots = [
            np.full((2, size), EMPTY, dtype=np.int32) for _ in range(6)
        ]  # w0 w1 w2 w3 len id
        sln = slots[4]
        hu, hv = word_key(w0, w1, w2, w3, ln)
        h1 = pair_hash1(hu, hv, mask)
        h2 = pair_hash2(hu, hv, mask)
        ok = True
        for i in range(n_entries):
            t = 0
            entry = [int(w0[i]), int(w1[i]), int(w2[i]), int(w3[i]),
                     int(ln[i]), int(wid[i])]
            s = int(h1[i])
            for _kick in range(500):
                if sln[t, s] == EMPTY:
                    for k in range(6):
                        slots[k][t, s] = entry[k]
                    break
                for k in range(6):
                    entry[k], slots[k][t, s] = int(slots[k][t, s]), entry[k]
                t = 1 - t
                ua, va = word_key(
                    np.asarray([entry[0]], np.int32),
                    np.asarray([entry[1]], np.int32),
                    np.asarray([entry[2]], np.int32),
                    np.asarray([entry[3]], np.int32),
                    np.asarray([entry[4]], np.int32),
                )
                s = int((pair_hash1 if t == 0 else pair_hash2)(ua, va, mask)[0])
            else:
                ok = False
                break
        if ok:
            return (*slots, mask)
        size *= 2
    raise RuntimeError("word-table cuckoo build failed to converge")


def build_packed(name: str, ranks: Dict[bytes, int]) -> PackedVocabulary:
    n_tokens = max(ranks.values()) + 1
    lengths = np.zeros(n_tokens, dtype=np.int32)
    for token, rank in ranks.items():
        lengths[rank] = len(token)
    offsets = np.zeros(n_tokens + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    pool = np.zeros(int(offsets[-1]), dtype=np.uint8)
    for token, rank in ranks.items():
        o = offsets[rank]
        pool[o : o + len(token)] = np.frombuffer(token, dtype=np.uint8)

    byte_to_id = np.full(256, EMPTY, dtype=np.int32)
    for b in range(256):
        rank = ranks.get(bytes([b]))
        if rank is not None:
            byte_to_id[b] = rank

    byte_pair_id = np.full(65536, EMPTY, dtype=np.int32)
    for token, rank in ranks.items():
        if len(token) == 2:
            byte_pair_id[token[0] * 256 + token[1]] = rank

    u_arr, v_arr, id_arr = _enumerate_pairs(ranks)
    cu, cv, cid, mask = _build_cuckoo(u_arr, v_arr, id_arr)
    ww0, ww1, ww2, ww3, wln, wid, wmask = _build_word_table(ranks)

    minL_gt, minR_gt = _build_threat_tables(
        u_arr, v_arr, id_arr, lengths, n_tokens
    )
    csafe = np.stack(
        [_safety_masks(cu[t], cv[t], cid[t], minL_gt, minR_gt) for t in (0, 1)]
    )
    # byte-pair seed with the l=1 safety bits (round 1: all neighbors are
    # single bytes, so any future threat strictly contains a 1-byte span)
    bseed = np.full(65536, EMPTY, dtype=np.int32)
    bp = byte_pair_id
    occ = bp >= 0
    b0 = np.arange(65536, dtype=np.int64) >> 8
    b1 = np.arange(65536, dtype=np.int64) & 0xFF
    u_id = byte_to_id[b0]
    v_id = byte_to_id[b1]
    ok = occ & (u_id >= 0) & (v_id >= 0)
    sl = (bp < minR_gt[np.clip(u_id, 0, None), 1]).astype(np.int32)
    sr = (bp <= minL_gt[np.clip(v_id, 0, None), 1]).astype(np.int32)
    bseed[ok] = bp[ok] | (sl[ok] << 18) | (sr[ok] << 19)
    return PackedVocabulary(
        name=name,
        n_tokens=n_tokens,
        max_token_len=int(lengths.max()) if n_tokens else 0,
        token_offsets=offsets.astype(np.int32),
        token_bytes=pool,
        token_lengths=lengths,
        byte_to_id=byte_to_id,
        byte_pair_id=byte_pair_id,
        cuckoo_u=cu,
        cuckoo_v=cv,
        cuckoo_id=cid,
        table_mask=mask,
        n_pairs=len(u_arr),
        word_w0=ww0,
        word_w1=ww1,
        word_w2=ww2,
        word_w3=ww3,
        word_len=wln,
        word_id=wid,
        word_mask=wmask,
        cuckoo_safe=csafe,
        byte_pair_seed=bseed,
    )


_ARRAY_FIELDS = (
    "token_offsets",
    "token_bytes",
    "token_lengths",
    "byte_to_id",
    "byte_pair_id",
    "cuckoo_u",
    "cuckoo_v",
    "cuckoo_id",
    "word_w0",
    "word_w1",
    "word_w2",
    "word_w3",
    "word_len",
    "word_id",
    "cuckoo_safe",
    "byte_pair_seed",
)
_SCALAR_FIELDS = ("n_tokens", "max_token_len", "table_mask", "n_pairs", "word_mask")


def _cache_dir() -> str:
    return os.path.join(os.path.dirname(__file__), "_packed_cache")


def load_packed(name: str, ranks: Dict[bytes, int], vocab_path: str | None = None) -> PackedVocabulary:
    """Build (or load cached) packed tables for a named vocabulary."""
    cache_path = None
    if vocab_path and os.path.exists(vocab_path):
        st = os.stat(vocab_path)
        key = f"{name}_v3_{st.st_size}_{int(st.st_mtime)}"
        cache_path = os.path.join(_cache_dir(), f"{key}.npz")
        if os.path.exists(cache_path):
            try:
                with np.load(cache_path) as z:
                    kwargs = {f: z[f] for f in _ARRAY_FIELDS}
                    kwargs.update({f: int(z[f]) for f in _SCALAR_FIELDS})
                    return PackedVocabulary(name=name, **kwargs)
            except Exception:
                pass  # corrupt cache: rebuild
    packed = build_packed(name, ranks)
    if cache_path:
        try:
            os.makedirs(_cache_dir(), exist_ok=True)
            tmp = f"{cache_path}.tmp.{os.getpid()}"
            np.savez(
                tmp,
                **{f: getattr(packed, f) for f in _ARRAY_FIELDS},
                **{f: getattr(packed, f) for f in _SCALAR_FIELDS},
            )
            os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp, cache_path)
        except OSError:
            pass
    return packed
