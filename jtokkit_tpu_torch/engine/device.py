"""Device engine: the staged batch encode pipeline and batch decode on a
CUDA card.

Counterpart of ``jtokkit_tpu/engine/device.py`` (the staged path, its
long-piece fallback and the decode methods). Per batch (documents -> token
ids):

1. Documents are packed into flat byte chunks (``chunk_bytes``, 1 MiB by
   default) with one separator byte between documents; validity is derived
   on the device from the doc-end table.
2. Stage A (``ops/stage4.stage_a_v4``) per chunk: classify, piece
   boundaries, piece table, word-table direct hits, miss list grouped by
   length bucket.
3. Host sync 1: ONE fetch of every chunk's meta row. Chunks whose piece or
   miss table overflowed run Stage A again with the roomy capacities.
   Chunks with a piece longer than the largest merge bucket (4096 bytes of
   one regex piece) leave the staged path (``fallback_chunks``): their
   piece boundaries (``ops/boundaries.piece_starts``) and the row-major
   merge of every piece up to 4096 bytes (``ops/merge.merge_rows``) still
   run on the device, and only the oversized pieces themselves are merged
   on the host, one by one (``host_pieces``).
4. Stage B per nonempty bucket: exact byte-pair merge
   (``ops/pipeline.merge_bucket_v3``), capacity the smallest power of two
   covering the bucket's count.
5. Stage C: counts, offsets, token scatters, per-document counts.
6. Host sync 2: ONE fetch of every chunk's token count and document counts,
   then one fetch of all chunks' live token prefixes.

Batch decode (token ids -> bytes) concatenates the lists, runs
``ops/decode.decode_tokens`` once and fetches the bytes once; lists with a
special or unknown id go to the host oracle, list by list.

Entry points run on CUDA unless the caller names another device; without a
card they raise.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import boundaries, classify, decode as decode_ops, merge, pipeline, stage4
from ..vocab import tables as vtables
from ..vocab.loader import asset_path
from .oracle import OracleEngine, byte_pair_merge
from .tables import DeviceTables

CHUNK_BYTES = 1 << 20
# the long-piece fallback's row-major merge buckets (piece bytes per row) and
# its least row count
_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
_MIN_ROWS = 128
_DOC_SIZES = (64, 1024, 16384, 262144)

# (piece_div, miss_div) capacity variants: the primary sizing covers natural
# text; the roomy sizing suffices for ANY input (every piece is >= 1 byte,
# every miss >= 2 bytes) and runs only on a capacity-overflow retry.
_DIVS_PRIMARY = (4, 32)
# non-ASCII chunks miss the word table far more often (CJK letter runs are
# all misses), so their primary miss table is roomier
_DIVS_PRIMARY_UNICODE = (4, 8)
_DIVS_ROOMY = (1, 2)


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; raise when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "jtokkit_tpu_torch runs on a CUDA device and none is"
                " available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def _next_pow2(n: int, floor: int = 1) -> int:
    n = max(n, floor)
    return 1 << (n - 1).bit_length()


def _quantize(n: int, sizes) -> int:
    for s in sizes:
        if n <= s:
            return s
    # beyond the largest quantized size (one giant unsplittable doc)
    return _next_pow2(n)


class DeviceEngine:
    """Batch encode engine for one encoding (built-in patterns only)."""

    # capacity variants per bucket: smallest power of two >= count, floored,
    # clamped to the guaranteed maximum for the chunk size
    _CAP_FLOOR = 512
    # pieces of len > prev_width fit at most N/(prev_width+1) times in N
    # bytes; the 8-lane bucket is bounded by the miss table (misses >= 2 bytes)
    _BUCKET_MAX_DIV = {
        8: 2, 16: 9, 32: 17, 64: 33, 128: 65, 256: 129, 384: 257,
        512: 385, 4096: 513,
    }

    def __init__(self, name: str, pattern: str, packed: vtables.PackedVocabulary,
                 oracle: OracleEngine, *, device=None,
                 chunk_bytes: int = CHUNK_BYTES):
        self.name = name
        self.pattern = pattern
        self.packed = packed
        self.oracle = oracle
        self.device = resolve_device(device)
        self.tables = DeviceTables.from_packed(packed, self.device)
        self.chunk_bytes = max(2, int(chunk_bytes) & ~1)
        self._flat_sizes = tuple(
            s for s in (8192, 131072, 1 << 21) if s < self.chunk_bytes
        ) + (self.chunk_bytes,)
        # chunks that took the long-piece fallback, pieces it merged on the
        # host, and Stage A runs (retries too)
        self.fallback_chunks = 0
        self.host_pieces = 0
        self.stage_a_runs = 0

    @classmethod
    def from_oracle(cls, oracle: OracleEngine, *, device=None,
                    chunk_bytes: int = CHUNK_BYTES) -> "DeviceEngine":
        device = resolve_device(device)
        packed = vtables.load_packed(
            oracle.name, oracle.ranks, _maybe_asset_path(oracle.name)
        )
        return cls(oracle.name, oracle.pattern, packed, oracle,
                   device=device, chunk_bytes=chunk_bytes)

    # ------------------------------------------------------------------
    # chunk planning (host, numpy)
    # ------------------------------------------------------------------

    @staticmethod
    def _safe_split(data: bytes, limit: int) -> int:
        """Largest split point <= limit that is provably a piece boundary
        for both patterns: the previous byte is an ASCII letter/digit and
        the byte at the split is CR/LF. Returns 0 if there is none."""
        w = np.frombuffer(data[:limit], dtype=np.uint8)
        if len(w) < 2:
            return 0
        is_crlf = (w[1:] == 0x0A) | (w[1:] == 0x0D)
        prev = w[:-1]
        is_alnum = (
            ((prev >= 0x30) & (prev <= 0x39))
            | ((prev >= 0x41) & (prev <= 0x5A))
            | ((prev >= 0x61) & (prev <= 0x7A))
        )
        cand = np.flatnonzero(is_crlf & is_alnum)
        return int(cand[-1]) + 1 if len(cand) else 0

    def _plan_chunks(self, texts: Sequence[Optional[str]]):
        """Split the batch into chunks.

        Yields (buf, doc_ends, parts, ascii_only) where parts[i] = original
        doc index of chunk-document i (one doc may span several
        chunk-documents across chunks, in order).
        """
        limit = self.chunk_bytes
        pending = []  # (doc_idx, bytes)
        for i, t in enumerate(texts):
            data = t.encode("utf-8") if t else b""
            while len(data) > limit - 1:
                p = self._safe_split(data, limit - 1)
                if p == 0:
                    break  # no safe point: single giant piece-dense doc
                pending.append((i, data[:p]))
                data = data[p:]
            pending.append((i, data))

        chunk: List = []
        size = 0
        for item in pending:
            extra = len(item[1]) + (1 if chunk else 0)
            if chunk and size + extra > limit:
                yield self._build_chunk(chunk)
                chunk, size = [], 0
            chunk.append(item)
            size += len(item[1]) + 1
        if chunk:
            yield self._build_chunk(chunk)

    def _build_chunk(self, items):
        total = sum(len(d) for (_i, d) in items) + len(items) - 1
        size = _quantize(total, self._flat_sizes)
        buf = np.zeros(size, dtype=np.uint8)
        ends = np.zeros(len(items), dtype=np.int32)
        parts = []
        pos = 0
        for k, (i, data) in enumerate(items):
            if k > 0:
                pos += 1  # separator (invalid byte; derived on the device)
            if data:
                buf[pos : pos + len(data)] = np.frombuffer(data, np.uint8)
                pos += len(data)
            ends[k] = pos
            parts.append(i)
        d_size = _quantize(len(items), _DOC_SIZES)
        doc_ends = np.full(d_size, pos, dtype=np.int32)
        doc_ends[: len(items)] = ends
        ascii_only = bool(buf.max(initial=0) < 0x80)
        return buf, doc_ends, parts, ascii_only

    # ------------------------------------------------------------------
    # staged pipeline
    # ------------------------------------------------------------------

    def _bucket_cap(self, n_chunk: int, lanes: int, count: int) -> int:
        max_cap = max(n_chunk // self._BUCKET_MAX_DIV[lanes], 8)
        return min(_next_pow2(count, self._CAP_FLOOR), _next_pow2(max_cap))

    def preload_corpus(self, texts: Sequence[Optional[str]]):
        """Chunk-plan a corpus and copy its buffers to the device once.

        Returns a list of (buf, doc_ends, parts, ascii_only, buf_dev,
        doc_ends_dev) that the batch methods accept as ``plan``.
        """
        return [
            (buf, doc_ends, parts, ascii_only,
             torch.from_numpy(buf).to(self.device),
             torch.from_numpy(doc_ends).to(self.device))
            for buf, doc_ends, parts, ascii_only in self._plan_chunks(texts)
        ]

    def _stage_a(self, variant: str, divs, buf_dev, doc_ends_dev):
        self.stage_a_runs += 1
        t = self.tables
        return stage4.stage_a_v4(
            buf_dev, doc_ends_dev, t.class_table, self.pattern, t.word_rows,
            t.word_mask, variant=variant, piece_div=divs[0], miss_div=divs[1],
        )

    def _process_chunks(self, texts, want_tokens: bool, plan=None):
        """Run the staged pipeline over all chunks with one batched host
        sync for the Stage A metadata (plus one on a capacity retry).

        Returns one result per chunk: ("ok", parts, tokens, n_tokens,
        doc_counts) with device tensors, or ("fallback", buf, doc_ends,
        parts).
        """
        if plan is None:
            plan = self.preload_corpus(texts)
        staged = []
        for buf, doc_ends, parts, ascii_only, buf_dev, doc_ends_dev in plan:
            variant = "ascii" if ascii_only else "unicode"
            divs = _DIVS_PRIMARY if ascii_only else _DIVS_PRIMARY_UNICODE
            table, meta = self._stage_a(variant, divs, buf_dev, doc_ends_dev)
            staged.append([buf, doc_ends, parts, variant, table, meta,
                           buf_dev, doc_ends_dev])
        if not staged:
            return []

        # sync round 1: ONE fetch of all chunk metas
        metas = torch.stack([s[5] for s in staged]).cpu().numpy()

        # capacity-overflow retries (the roomy variant suffices for any
        # input). A truncated piece table also reads as PIECE_LEN (its last
        # piece runs to the buffer's end), so that bit is trusted only from
        # a run without CAPACITY.
        retried = []
        for i, s in enumerate(staged):
            if int(metas[i][0]) & stage4.OVERFLOW_CAPACITY:
                s[4], s[5] = self._stage_a(s[3], _DIVS_ROOMY, s[6], s[7])
                retried.append(i)
        if retried:
            re_metas = torch.stack([staged[i][5] for i in retried]).cpu().numpy()
            for k, i in enumerate(retried):
                metas[i] = re_metas[k]

        t_ = self.tables
        results = []
        for i, (buf, doc_ends, parts, _variant, t, _meta, buf_dev,
                de_dev) in enumerate(staged):
            overflow = int(metas[i][0])
            if overflow & (stage4.OVERFLOW_PIECE_LEN | stage4.OVERFLOW_CAPACITY):
                self.fallback_chunks += 1
                results.append(("fallback", buf, doc_ends, parts))
                continue
            bucket_counts = metas[i][2:]
            N = len(buf)
            counts = pipeline.counts_init(t.hit, t.n_pieces)
            bucket_outs = []
            for b, lanes in enumerate(stage4.BUCKET_WIDTHS):
                cnt = int(bucket_counts[b])
                if cnt == 0:
                    continue
                cap = self._bucket_cap(N, lanes, cnt)
                cols, ids, active = pipeline.merge_bucket_v3(
                    buf_dev, t.starts, t.lens, t.miss_sorted,
                    t.group_start[b], cnt, t_.byte_to_id, t_.byte_pair_id,
                    t_.pair_rows_cat, t_.table_mask, lanes=lanes, cap=cap,
                )
                counts = pipeline.counts_add_bucket(counts, cols, active)
                bucket_outs.append((cols, ids, active))
            offsets, n_tokens = pipeline.make_offsets(counts, t.n_pieces)
            tokens = None
            if want_tokens:
                tokens = pipeline.scatter_hits(N, t.hit, offsets, t.n_pieces)
                for cols, ids, active in bucket_outs:
                    tokens = pipeline.scatter_bucket(
                        tokens, ids, active, cols, offsets
                    )
            doc_counts = stage4.doc_token_counts_v4(
                offsets, n_tokens, t.starts, de_dev, t.n_pieces
            )
            results.append(("ok", parts, tokens, n_tokens, doc_counts))
        return results

    # ------------------------------------------------------------------
    # long-piece fallback: boundaries and bucket merges on the device,
    # packing and stitching on the host
    # ------------------------------------------------------------------

    @staticmethod
    def _chunk_valid(doc_ends: np.ndarray, parts, size: int) -> np.ndarray:
        """Host-side validity mask (Stage A derives its own on the device)."""
        used = int(doc_ends[len(parts) - 1])
        valid = np.zeros(size, dtype=bool)
        valid[:used] = True
        for k in range(len(parts) - 1):
            valid[int(doc_ends[k])] = False
        return valid

    def _pieces(self, buf, valid, bounds, used) -> Tuple[np.ndarray, np.ndarray]:
        """(piece_starts, piece_lens) in flat-buffer coordinates."""
        info = classify.classify_bytes(
            torch.from_numpy(buf).to(self.device), self.tables.class_table,
            torch.from_numpy(valid).to(self.device),
        )
        mask = boundaries.piece_starts(info, self.pattern).cpu().numpy()
        starts = np.flatnonzero(mask[:used])
        if len(starts) == 0:
            return starts.astype(np.int64), starts.astype(np.int64)
        # pieces end at the next piece start or their doc's end (separators
        # are never piece starts, so clamp by doc end)
        doc_ends = np.asarray([e for (_s, e) in bounds], dtype=np.int64)
        next_start = np.append(starts[1:], used)
        doc_of = np.searchsorted(doc_ends, starts, side="right")
        doc_of = np.minimum(doc_of, len(doc_ends) - 1)
        ends = np.minimum(next_start, doc_ends[doc_of])
        return starts.astype(np.int64), (ends - starts).astype(np.int64)

    def _encode_flat(self, buf, starts, lens):
        """Token ids for every piece, stitched into one flat token array plus
        per-piece offsets (order = piece order)."""
        n_pieces = len(starts)
        counts = np.zeros(n_pieces, dtype=np.int64)
        piece_tokens: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        t = self.tables

        bucket_of = np.searchsorted(np.asarray(_BUCKETS), lens, side="left")
        oversized = bucket_of >= len(_BUCKETS)

        for b_idx, lanes in enumerate(_BUCKETS):
            sel = np.flatnonzero((bucket_of == b_idx) & ~oversized)
            if len(sel) == 0:
                continue
            R = _next_pow2(len(sel), _MIN_ROWS)
            mat = np.zeros((R, lanes), dtype=np.uint8)
            blens = np.zeros((R,), dtype=np.int32)
            # gather piece bytes: rows x lanes fancy index into flat buffer
            gidx = starts[sel][:, None] + np.arange(lanes)[None, :]
            np.minimum(gidx, len(buf) - 1, out=gidx)
            rows = buf[gidx]
            lane_mask = np.arange(lanes)[None, :] < lens[sel][:, None]
            mat[: len(sel)] = np.where(lane_mask, rows, 0)
            blens[: len(sel)] = lens[sel]

            ids, active = merge.merge_rows(
                torch.from_numpy(mat).to(self.device),
                torch.from_numpy(blens).to(self.device),
                t.byte_to_id, t.byte_pair_id, t.pair_rows_cat, t.table_mask,
            )
            ids = ids[: len(sel)].cpu().numpy()
            active = active[: len(sel)].cpu().numpy()
            counts[sel] = active.sum(axis=1)
            piece_tokens.append((sel, ids, active))

        # pieces over the largest bucket merge on the host, one by one
        over_tokens = {}
        for pi in np.flatnonzero(oversized):
            pc = bytes(buf[starts[pi] : starts[pi] + lens[pi]])
            rank = self.oracle.ranks.get(pc)
            toks = [rank] if rank is not None else byte_pair_merge(pc, self.oracle.ranks)
            over_tokens[pi] = toks
            counts[pi] = len(toks)
            self.host_pieces += 1

        # stitch: output offsets per piece, scatter each bucket's tokens
        offsets = np.zeros(n_pieces + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        out = np.zeros(int(offsets[-1]), dtype=np.int32)
        for sel, ids, active in piece_tokens:
            pos_in_row = np.cumsum(active, axis=1) - 1
            tgt = offsets[sel][:, None] + pos_in_row
            out[tgt[active]] = ids[active]
        for pi, toks in over_tokens.items():
            out[offsets[pi] : offsets[pi] + len(toks)] = toks
        return out, offsets

    def _encode_chunk_fallback(self, buf, doc_ends, parts):
        """[(doc_idx, int32 tokens)] of one chunk with a piece over the
        largest bucket, one entry per chunk-document in order."""
        valid = self._chunk_valid(doc_ends, parts, len(buf))
        used = int(doc_ends[len(parts) - 1])
        bounds = []
        prev = 0
        for k in range(len(parts)):
            end = int(doc_ends[k])
            start = prev if k == 0 else prev + 1
            bounds.append((start, end))
            prev = end
        starts, lens = self._pieces(buf, valid, bounds, used)
        flat, offsets = self._encode_flat(buf, starts, lens)
        ends_arr = np.asarray([e for (_s, e) in bounds], dtype=np.int64)
        # pieces are in stream order: document d owns one contiguous run
        doc_of = np.minimum(
            np.searchsorted(ends_arr, starts, side="right"), len(ends_arr) - 1
        )
        first = np.searchsorted(doc_of, np.arange(len(parts) + 1), side="left")
        return [
            (doc_idx, flat[offsets[first[d]] : offsets[first[d + 1]]])
            for d, doc_idx in enumerate(parts)
        ]

    # ------------------------------------------------------------------
    # public batch API
    # ------------------------------------------------------------------

    def encode_ordinary_batch_arrays(
        self, texts: Sequence[Optional[str]], plan=None
    ) -> List[np.ndarray]:
        """Token ids per document as int32 numpy arrays.

        One fetch of every chunk's (n_tokens, doc_counts), then one fetch of
        all chunks' live token prefixes, concatenated on the device.
        """
        if texts is None and plan is None:
            return []
        n_docs = (
            len(texts) if texts is not None
            else 1 + max(p for entry in plan for p in entry[2])
        )
        parts_out: List[List[np.ndarray]] = [[] for _ in range(n_docs)]
        results = self._process_chunks(texts, want_tokens=True, plan=plan)
        ok = [r for r in results if r[0] == "ok"]
        if ok:
            small = torch.cat(
                [torch.stack([r[3] for r in ok])] + [r[4] for r in ok]
            ).cpu().numpy()
            n_tok = [int(x) for x in small[: len(ok)]]
            flat = torch.cat(
                [r[2][:n] for r, n in zip(ok, n_tok)]
            ).cpu().numpy()
        oki = 0
        tok_pos = 0
        meta_pos = len(ok)
        for res in results:
            if res[0] == "fallback":
                for doc_idx, toks in self._encode_chunk_fallback(*res[1:]):
                    parts_out[doc_idx].append(toks)
                continue
            parts, d_size = res[1], int(res[4].shape[0])
            n = n_tok[oki]
            doc_counts = small[meta_pos : meta_pos + len(parts)]
            tokens = flat[tok_pos : tok_pos + n]
            oki += 1
            tok_pos += n
            meta_pos += d_size
            splits = np.cumsum(doc_counts)[:-1]
            for doc_idx, toks in zip(parts, np.split(tokens, splits)):
                parts_out[doc_idx].append(toks)
        empty = np.zeros((0,), np.int32)
        return [
            ps[0] if len(ps) == 1
            else (np.concatenate(ps) if ps else empty)
            for ps in parts_out
        ]

    def encode_ordinary_batch(
        self, texts: Sequence[Optional[str]]
    ) -> List[List[int]]:
        if not texts:
            return []
        return [a.tolist() for a in self.encode_ordinary_batch_arrays(texts)]

    def count_tokens_batch(self, texts: Sequence[Optional[str]]) -> List[int]:
        if not texts:
            return []
        counts = [0] * len(texts)
        results = self._process_chunks(texts, want_tokens=False)
        ok = [r for r in results if r[0] == "ok"]
        if ok:
            small = torch.cat([r[4] for r in ok]).cpu().numpy()
        pos = 0
        for res in results:
            if res[0] == "fallback":
                for doc_idx, toks in self._encode_chunk_fallback(*res[1:]):
                    counts[doc_idx] += len(toks)
                continue
            parts, doc_counts_dev = res[1], res[4]
            for doc_idx, c in zip(parts, small[pos : pos + len(parts)]):
                counts[doc_idx] += int(c)
            pos += int(doc_counts_dev.shape[0])
        return counts

    # ------------------------------------------------------------------
    # batch decode
    # ------------------------------------------------------------------

    def _split_plain_lists(self, token_lists):
        """Sort the lists into those of plain vocabulary ids (concatenated)
        and those with a special or out-of-vocabulary id, which the host
        oracle decodes list by list (keeping its errors and special tokens).

        Returns (out, flat, splits): ``out[i]`` holds the oracle's bytes or
        None, ``flat`` the int64 ids of the plain lists, ``splits`` their
        (list index, lo, hi) ranges in ``flat``.
        """
        out: List[Optional[bytes]] = [None] * len(token_lists)
        arrs: List[np.ndarray] = []
        splits: List[Tuple[int, int, int]] = []
        pos = 0
        for i, toks in enumerate(token_lists):
            arr = (
                toks.astype(np.int64)
                if isinstance(toks, np.ndarray)
                else np.asarray(list(toks), dtype=np.int64)
            )
            if len(arr) and (arr.min() < 0 or arr.max() >= self.packed.n_tokens):
                out[i] = self.oracle.decode_bytes(arr.tolist())
            else:
                splits.append((i, pos, pos + len(arr)))
                arrs.append(arr)
                pos += len(arr)
        flat = np.concatenate(arrs) if pos else np.zeros(0, np.int64)
        return out, flat, splits

    @staticmethod
    def _cut_lists(out, data: bytes, byte_ends, splits) -> List[bytes]:
        for i, lo, hi in splits:
            blo = 0 if lo == 0 else int(byte_ends[lo - 1])
            bhi = 0 if hi == 0 else int(byte_ends[hi - 1])
            out[i] = data[blo:bhi]
        return [b if b is not None else b"" for b in out]

    def decode_bytes_batch_host(self, token_lists) -> List[bytes]:
        """Host decode in numpy: one fancy-index gather over the packed byte
        pool. No device is touched."""
        out, flat, splits = self._split_plain_lists(token_lists)
        byte_ends, data = None, b""
        if len(flat):
            lens = self.packed.token_lengths[flat].astype(np.int64)
            byte_ends = np.cumsum(lens)
            total = int(byte_ends[-1])
            # pool index of output byte p from token t: pool_start[t] +
            # (p - out_start[t]); fold per-token terms, then one gather
            adj = self.packed.token_offsets[flat].astype(np.int64) - (
                byte_ends - lens
            )
            src = np.repeat(np.arange(len(flat)), lens)
            data = self.packed.token_bytes[adj[src] + np.arange(total)].tobytes()
        return self._cut_lists(out, data, byte_ends, splits)

    def decode_bytes_batch_device(self, token_lists) -> List[bytes]:
        """Decode on the engine's device: the lists' ids go up in one
        tensor, ``ops/decode.decode_tokens`` runs once (one scan), and the
        live byte prefix comes back in one fetch."""
        out, flat, splits = self._split_plain_lists(token_lists)
        byte_ends, data = None, b""
        if len(flat):
            n = len(flat)
            tokens = np.full(_next_pow2(n, 1024), -1, dtype=np.int32)
            tokens[:n] = flat
            byte_ends = np.cumsum(self.packed.token_lengths[flat])
            total_bytes = int(byte_ends[-1])
            # the byte count is known on the host, so the output capacity
            # tracks content
            cap = _next_pow2(total_bytes, 8192)
            t = self.tables
            data_dev, _n_bytes = decode_ops.decode_tokens(
                torch.from_numpy(tokens).to(self.device), n,
                t.token_offsets, t.token_bytes, cap,
            )
            data = data_dev[:total_bytes].cpu().numpy().tobytes()
        return self._cut_lists(out, data, byte_ends, splits)

    def decode_bytes_batch(self, token_lists) -> List[bytes]:
        return self.decode_bytes_batch_device(token_lists)


def _maybe_asset_path(name: str):
    try:
        return asset_path(name)
    except Exception:
        return None
