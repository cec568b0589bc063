"""Device engine: the staged batch encode pipeline, its steady state over a
warmed corpus plan, and batch decode on a CUDA card.

Counterpart of ``jtokkit_tpu/engine/device.py`` (the staged path, the warmed
``CorpusPlan`` passes with the packed token fetch and the corpus-mapped
count, the long-piece fallback and the decode methods; the reference's
wide-bucket hybrid merge has no counterpart here: every bucket merges on
the merge kernel). Per batch (documents -> token ids):

1. Documents are packed into flat byte chunks (``chunk_bytes``, 1 MiB by
   default) with one separator byte between documents, by the native chunk
   packer (``pack.py``, ``csrc/pack.cc``: each document's UTF-8 written from
   its ``str`` storage); validity is derived on the device from the
   doc-end table.
2. Stage A (``ops/stage4.stage_a_v4``) per chunk: classify, piece
   boundaries, piece table, word-table direct hits, miss list grouped by
   length bucket. Without a plan, steps 1 and 2 are streamed: each chunk
   is uploaded from pinned memory without a wait and its Stage A issued as
   soon as it is packed, so the card runs it while the host packs the next.
3. Host read 1: ONE fetch of every chunk's meta row. Chunks whose piece or
   miss table overflowed run Stage A again with the roomy capacities.
   Chunks with a piece longer than the largest merge bucket (4096 bytes of
   one regex piece) leave the staged path (``fallback_chunks``): their
   piece boundaries (``ops/boundaries.piece_starts``) and the row-major
   merge of every piece up to 4096 bytes (``ops/merge.merge_rows``, on
   CUDA the merge kernel) still run on the device, and only the oversized
   pieces themselves are merged on the host, one by one (``host_pieces``).
   Chunks whose pieces over 64 bytes may cover more than a quarter of
   their bytes go to the native C++ host engine instead (``native.py``;
   ``native_chunks``), as in the reference: there the device merge would
   run one round per byte of the longest piece. ``native_long=False``
   keeps them on the device.
4. Stage B per nonempty bucket: exact byte-pair merge
   (``ops/pipeline.merge_bucket_v3``), capacity the smallest power of two
   covering the bucket's count; on CUDA ONE launch of the merge kernel
   (``csrc/merge.cu``) a bucket, every piece merged to its end.
5. Stage C: counts, offsets, token scatters, per-document counts.
6. Host read 2: ONE fetch of every chunk's token count and document counts,
   then every chunk's live token prefix, packed to 2 bytes a token (plus a
   1-bit plane where ids need a 17th bit), copied into pinned host memory
   without blocking, and ONE wait before the first is consumed. (The
   reference also ships a 12-bit plane where it is smaller; on this port's
   card its pack and unpack cost more than the bytes it saves, so the port
   has none.)

On CUDA this path runs from the engine's graph cache (``cold_cache``, the
counterpart of the reference's jit caches keyed by shape): Stage A of a
chunk is the replay of a CUDA graph keyed by (variant, capacity divisors,
flat size, document slots), its Stages B and C one graph keyed by that and
the buckets' capacities, whose live counts it takes from the piece table on
the card. A shape met for the first time is captured then. A bucket's
merge inside these graphs is one merge kernel, which writes the rounds the
merge loop would have run into a counter. So the only host reads are the
two above (a count needs only the document counts) and the fetch wait; the
round counters come back with the last read. The fallback's bucket merge
is one kernel launch and one read of its ids, active lanes and counter.
``cold_cache=False`` (the default on a CPU device) issues every op eagerly
and reads each bucket's round counter back (on the CPU: each merge loop's
exit test after every round).

Steady state (``plan = preload_corpus(texts)``, then the batch methods with
``plan=plan``): the first pass over a plan is the cold pass above and leaves
its routing, bucket capacities and merge round counts in the plan
(``chunk_cache``); the first encode pass adds the token and document counts.
Later passes dispatch every chunk's stages back to back from the cache with
no host read between the first launch and the fetch
(:meth:`DeviceEngine._process_chunks_cached`); the token copies start inside
the dispatch. Once the first encode pass has cached the token and document
counts, the next one captures each ok-chunk's body (Stage A, merges, Stage
C, pack) as ONE CUDA graph, and every later encode pass is one replay per
chunk, each followed by its chunk's copies, and one wait (the counterpart
of the reference's jitted per-stage programs).
:meth:`DeviceEngine.encode_plan_tokens` is the same pass kept on the
device: no copy, the plan's token ids as one int32 tensor.
``count_tokens_corpus`` over a warmed plan runs the corpus-mapped count:
blocks of up to 8 chunks of one shape, each ONE CUDA
graph captured once per plan and replayed per pass, and one scalar fetch.
On a CPU device both bodies run eagerly. All cached values derive from the
plan's immutable buffers, so reuse is exact; tokens are computed from the
bytes on every pass.
``host_reads`` counts every fetch of device data. ``merge_rounds`` counts
the rounds the byte-pair merge loops ran, or would have run where the merge
kernel ran instead (the device counters come back with the call's last
read), ``miss_pieces`` the pieces sent to them: the bucket counts, from
the metas, of every chunk routed to Stages B-C of an un-planned or first
pass, ``pieces`` the pieces of those chunks (the metas' ``n_pieces``), and
``merge_kernel_runs`` the bucket merges run by the merge kernel (a launch
adds one; a graph replay adds the launches its capture holds).
``unicode_chunks`` counts the chunks staged at the ``"unicode"`` Stage A,
``capacity_retries`` the passes that ran Stage A again at the roomy
capacities and ``retried_chunks`` the chunks each such pass ran again; the
span ``capacity_retry`` holds that second Stage A with its metas read.
None of them adds a read.

Batch decode (token ids -> bytes) concatenates the lists, runs
``ops/decode.decode_tokens`` once and fetches the bytes once; lists with a
special or unknown id go to the host oracle, list by list.

Entry points run on CUDA unless the caller names another device; without a
card they raise.
"""

from __future__ import annotations

import os
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import pack
from ..ops import (
    _build, boundaries, classify, decode as decode_ops, merge, pipeline, scan,
    stage4,
)
from ..utils.spans import span
from ..vocab import tables as vtables
from ..vocab.loader import asset_path
from .oracle import OracleEngine, byte_pair_merge
from .tables import DeviceTables

CHUNK_BYTES = 1 << 20
# the long-piece fallback's row-major merge buckets (piece bytes per row) and
# its least row count
_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
_MIN_ROWS = 128
# a chunk's lengths: its bytes by ``flat_sizes(chunk_bytes)``, its document
# ends by these, each the first that holds it, else the next power of two
# (csrc/pack.cc)
_DOC_SIZES = (64, 1024, 16384, 262144)


def flat_sizes(chunk_bytes: int) -> tuple:
    """The sizes a chunk of an engine with ``chunk_bytes`` is padded to."""
    return tuple(s for s in (8192, 131072, 1 << 21) if s < chunk_bytes) + (chunk_bytes,)

# the named spans of the host path (``utils/spans.py``); the engine keeps
# the host time of each in ``<name>_ns``. Per batch call: ``encode`` or
# ``count`` (the whole call); inside it ``plan`` and ``upload`` (the chunk
# plan and its copy to the device), ``stage_a`` (every chunk's Stage A
# issue and the capacity retry) with ``metas_read`` and ``capacity_retry``
# (the roomy re-issue of the chunks that overflowed, with its own
# ``metas_read``) inside; an un-planned
# call enters ``plan``, ``upload`` and ``stage_a`` once a chunk, in turns,
# and its last ``stage_a`` holds the metas read too; ``stages_b_c``
# (routing and every chunk's Stages B-C issue), ``counts_read``, the
# encode's ``fetch`` (pack and copies), ``fetch_wait`` and
# ``unpack_split``, and ``host_chunks`` (native and fallback chunks) with
# ``native_wait`` inside. ``capture`` is a cached unit's first capture,
# inside the stage that met it; ``cached_dispatch`` the warmed plan's
# dispatch. ``special_check`` is the facade's special-token check of a
# batch count (``encoding_impl.py``). Beside the spans the engine counts
# ``unicode_chunks``, ``retried_chunks`` and ``pieces`` (see the module's
# docstring).
SPANS = (
    "encode", "count", "special_check", "plan", "upload", "stage_a",
    "metas_read", "capacity_retry", "stages_b_c", "counts_read", "fetch",
    "fetch_wait", "unpack_split", "host_chunks", "native_wait", "capture",
    "cached_dispatch",
)

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


class CorpusPlan(list):
    """Chunk plan (list of chunk entries) + steady-state dispatch cache.

    ``chunk_cache`` (set by the first full pass) holds per-chunk routing,
    bucket capacities and merge round counts, so later passes skip the
    Stage A metadata fetch and the merge loops' exit tests;
    ``n_tokens``/``doc_counts`` (set by the first *encode* pass) let later
    encode passes skip the small-meta fetch as well: steady state then has no
    host read before the token fetch. Every cached value derives from the
    plan's immutable buffers, so reuse is exact.
    """

    chunk_cache = None   # list[dict] per chunk: kind/variant/divs/caps/rounds
    mapped_count = None  # list[CountBlock] of the corpus-mapped count
    n_tokens = None      # list[int] per ok-chunk live token count
    doc_counts = None    # list[np.ndarray] per ok-chunk per-doc counts
    capture_seconds = 0.0   # spent capturing mapped_count's graphs
    graph_pool_bytes = 0    # device memory the graphs' shared pool reserved
    encode_graphs = None    # list[EncodeGraph] per ok-chunk of the warmed encode
    encode_capture_seconds = 0.0  # spent capturing encode_graphs
    encode_pool_bytes = 0         # device memory their shared pool reserved

    def __init__(self, *args):
        super().__init__(*args)
        # pinned host buffers of the token fetch, made once per chunk and
        # format: (ok-chunk index, format, pad[, ecap]) -> list of tensors
        self.pinned = {}


class _Captured:
    """A unit of work that runs as one CUDA graph on CUDA: ``out`` holds the
    graph's outputs, which every replay overwrites."""

    def __init__(self):
        self.graph = None
        self.out = None
        self.n_scans = 0    # scan calls recorded in the graph
        self.n_rounds = 0   # merge rounds recorded in the graph (fixed counts)
        self.n_merge_kernels = 0  # merge kernel launches recorded in the graph


class ColdUnit(_Captured):
    """One entry of the engine's cache for the un-planned path: a stage of
    one chunk at one shape (``key``), recorded once and replayed for every
    chunk of that shape. ``inputs`` are its static input tensors: each run
    copies the chunk's tensors into them on the card, and the caller clones
    what it keeps of ``out`` before the next run overwrites it. Each graph
    has a memory pool of its own, so units replay in any order. On a CPU
    device the body runs eagerly every time.
    """

    def __init__(self, key, inputs):
        super().__init__()
        self.key, self.inputs = key, inputs
        self.capture_seconds = 0.0
        self.pool_bytes = 0     # device memory reserved while it was captured


class CountBlock(_Captured):
    """Up to 8 chunks of one shape counted as one unit: on CUDA one captured
    graph whose replay leaves the block's token total in ``out``."""

    def __init__(self, variant, divs, sig, bufs, des, n_live):
        super().__init__()
        self.variant, self.divs, self.sig = variant, divs, sig
        self.bufs, self.des, self.n_live = bufs, des, n_live


class EncodeGraph(_Captured):
    """One ok-chunk of a warmed plan's encode (ok-chunk ``oki``, cache entry
    ``c``) as one captured graph: Stage A, the merges at their cached
    rounds, Stage C and the pack. A replay leaves (tokens, n_tokens, None,
    packed fetch) in ``out``, device tensors that the next replay
    overwrites. The copies of the packed arrays into the plan's pinned
    buffers (one or two a chunk) are issued after the replay, outside the
    graph: once graphs whose captured copies wrote pinned buffers had been
    freed with those buffers (as a dropped plan frees them), the next
    capture failed in the host allocator's cache flush (torch 2.11)."""

    def __init__(self, oki, c, buf_dev, de_dev):
        super().__init__()
        self.oki, self.c, self.buf_dev, self.de_dev = oki, c, buf_dev, de_dev


class ChunkResults(list):
    """One result per chunk (:meth:`DeviceEngine._process_chunks`).
    ``pending`` holds (chunk cache entry, device int32 round counters, one a
    bucket) per ok-chunk whose merges left their rounds on the device: the
    caller fetches them with its last read (``_read(t, results.pending)``),
    which fills the entries' rounds."""

    def __init__(self, *args):
        super().__init__(*args)
        self.pending = []


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
    # units each cache of the un-planned path keeps (least recently used
    # first out). Python source (variant, divisors, flat size, document
    # slots and bucket capacities varying by chunk) meets 29-35 shapes of
    # Stages B-C over a 256 MiB ring (H100 runs of the codex-p50k-encode
    # cell); at 32 units a cycle of the ring pushed some out, and they were
    # captured again inside the timed calls
    COLD_CACHE_MAX = 64

    def __init__(self, name: str, pattern: str, packed: vtables.PackedVocabulary,
                 oracle: OracleEngine, *, device=None,
                 chunk_bytes: int = CHUNK_BYTES,
                 native_long: bool = True,
                 cold_cache: Optional[bool] = None):
        self.name = name
        self.pattern = pattern
        self.packed = packed
        self.oracle = oracle
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # the kernels this engine launches, built together (one nvcc
            # each) where this checkout has no build of them yet
            _build.build_all([scan.LIBRARY, merge.LIBRARY])
        self.tables = DeviceTables.from_packed(packed, self.device)
        self.chunk_bytes = max(2, int(chunk_bytes) & ~1)
        self._flat_sizes = flat_sizes(self.chunk_bytes)
        # chunks that took the long-piece fallback, pieces it merged on the
        # host, and Stage A runs (retries too)
        self.fallback_chunks = 0
        self.host_pieces = 0
        self.stage_a_runs = 0
        # cold passes that ran Stage A again for a capacity overflow (each
        # one more read of metas), and the chunks they ran again
        self.capacity_retries = 0
        self.retried_chunks = 0
        # chunks staged at the "unicode" Stage A (a non-ASCII byte in them)
        self.unicode_chunks = 0
        # rounds the byte-pair merge loops ran, or would have run where the
        # merge kernel ran (:data:`merge.MERGE_ROUNDS`, per engine: the eager
        # merges as they run, the device forms when their counters are read
        # back), and the pieces sent to them (the
        # bucket counts of every chunk routed to Stages B-C, from the metas);
        # ``pieces`` the pieces of those chunks (the metas' n_pieces)
        self.merge_rounds = 0
        self.miss_pieces = 0
        self.pieces = 0
        # bucket merges run by the merge kernel (csrc/merge.cu): one a launch,
        # and a graph's recorded launches at each replay
        self.merge_kernel_runs = 0
        # chunks of un-planned calls whose Stage A was issued before the
        # call's last chunk was packed (n - 1 for a call of n chunks)
        self.streamed_chunks = 0
        # documents the chunk packer read from non-ASCII str storage
        # (transcoded to UTF-8 rather than copied)
        self.wide_docs = 0
        # fetches of device data by the host: every .cpu() / .item() of the
        # engine's paths (the cold merge loops' exit tests included) and the
        # one wait on a pass's token copies
        self.host_reads = 0
        # long-piece routing: chunks dominated by pieces over 64 bytes go to
        # the native host engine (built at the first such chunk), counted in
        # native_chunks
        self.native_long = bool(native_long)
        self.native_chunks = 0
        self._native = None
        self._native_looked_up = False
        # ids over 16 bits (cl100k) ship a 1-bit plane beside the low halves
        self._fetch_wide = packed.n_tokens > 0xFFFF
        self._capture_stream = None  # made at the first graph capture
        # replays of the engine's graphs (plans' and the un-planned path's);
        # the Stage A runs, scans and merge rounds inside a replay pass
        # through no Python and are in no counter (a unit's n_scans and
        # n_rounds say what it recorded; device-form merges report their
        # rounds through their counters)
        self.graph_replays = 0
        # the un-planned path's caches, the counterpart of the reference's
        # jit caches keyed by shape (on by default on CUDA; off, that path
        # issues every op eagerly and reads each bucket's rounds back):
        # Stage A by (variant, divs, N, D), Stages B and C of a chunk by
        # (variant, divs, N, D, bucket capacities, want_tokens)
        self.cold_cache = (
            self.device.type == "cuda" if cold_cache is None else bool(cold_cache)
        )
        self._cold = {"stage_a": OrderedDict(), "stages_b_c": OrderedDict()}
        self.cold_captures = 0          # units captured (CUDA)
        # spent in _capture's torch.cuda.empty_cache() (plans' captures)
        self.empty_cache_seconds = 0.0
        for name in SPANS:
            setattr(self, f"{name}_ns", 0)

    @classmethod
    def from_oracle(cls, oracle: OracleEngine, *, device=None,
                    chunk_bytes: int = CHUNK_BYTES,
                    native_long: bool = True,
                    cold_cache: Optional[bool] = None) -> "DeviceEngine":
        device = resolve_device(device)
        packed = vtables.load_packed(
            oracle.name, oracle.ranks, _maybe_asset_path(oracle.name)
        )
        return cls(oracle.name, oracle.pattern, packed, oracle,
                   device=device, chunk_bytes=chunk_bytes,
                   native_long=native_long, cold_cache=cold_cache)

    def _native_engine(self):
        """The shared native host engine for long-piece chunks, looked up at
        the first such chunk; None when routing is off or
        ``native.engine_for`` leaves the vocabulary out. A failed build
        raises."""
        if self.native_long and not self._native_looked_up:
            from .. import native

            self._native = native.engine_for(self.packed, self.pattern)
            self._native_looked_up = True
        return self._native

    def _read(self, t: torch.Tensor, pending=None) -> np.ndarray:
        """Fetch a device tensor to the host (one host read). ``pending``:
        the device round counters of a cold pass (:class:`ChunkResults`),
        fetched in the same read and settled (:meth:`_settle_rounds`)."""
        self.host_reads += 1
        if not pending:
            return t.cpu().numpy()
        flat = torch.cat([t.reshape(-1)] + [r.to(t.dtype) for _e, r in pending])
        host = flat.cpu().numpy()
        n = t.numel()
        self._settle_rounds(pending, host[n:])
        return host[:n].reshape(t.shape)

    def _settle_rounds(self, pending, flat) -> None:
        """Fill the chunk cache entries of ``pending`` ((entry, device round
        counters, one a bucket) per ok-chunk of a cold pass run from the
        graph cache) from their counters read back as ``flat``. The rounds
        are added to ``merge.MERGE_ROUNDS`` and ``merge_rounds``."""
        pos = 0
        for entry, counters in pending:
            ran = [int(x) for x in flat[pos : pos + counters.numel()]]
            pos += counters.numel()
            merge.MERGE_ROUNDS += sum(ran)
            self.merge_rounds += sum(ran)
            entry["rounds"] = ran
        pending.clear()

    # ------------------------------------------------------------------
    # chunk planning (host: the native chunk packer)
    # ------------------------------------------------------------------

    def _chunks(self, texts: Sequence[Optional[str]], pin: bool = False):
        """The batch packed into chunks by the native packer, one chunk a
        step (:class:`pack.ChunkPacker`): (buf, doc_ends, parts, ascii_only,
        last) with ``buf`` and ``doc_ends`` CPU tensors, pinned where
        ``pin``. A document is read only when the packing reaches it, and a
        chunk comes out as soon as the next document does not fit, so the
        caller can start on a chunk while the rest of the batch is
        unpacked. Adds the documents read from non-ASCII storage to
        ``wide_docs``."""
        packer = pack.ChunkPacker(texts, self.chunk_bytes, self._flat_sizes,
                                  _DOC_SIZES, pin=pin)
        counted = 0
        for chunk in packer:
            self.wide_docs += packer.wide_docs - counted
            counted = packer.wide_docs
            yield chunk

    def _plan_chunks(self, texts: Sequence[Optional[str]]):
        """Split the batch into chunks, lazily (:meth:`_chunks`).

        Yields (buf, doc_ends, parts, ascii_only) with numpy arrays, where
        parts[i] = original doc index of chunk-document i (one doc may span
        several chunk-documents across chunks, in order).
        """
        for buf, doc_ends, parts, ascii_only, _last in self._chunks(texts):
            yield buf.numpy(), doc_ends.numpy(), parts, ascii_only

    # ------------------------------------------------------------------
    # staged pipeline
    # ------------------------------------------------------------------

    def _bucket_cap(self, n_chunk: int, lanes: int, count: int) -> int:
        max_cap = max(n_chunk // self._BUCKET_MAX_DIV[lanes], 8)
        return min(_next_pow2(count, self._CAP_FLOOR), _next_pow2(max_cap))

    def preload_corpus(self, texts: Sequence[Optional[str]]) -> CorpusPlan:
        """Chunk-plan a corpus and copy its buffers to the device once.

        The returned plan (a list of (buf, doc_ends, parts, ascii_only,
        buf_dev, doc_ends_dev)) can be passed to the batch methods as
        ``plan`` again and again: passes then pay no host-to-device copy,
        and after the first full pass the plan also carries the dispatch
        metadata (see :class:`CorpusPlan`), so later passes read nothing
        back before their results.
        """
        with span(self, "plan"):
            chunks = list(self._plan_chunks(texts))
        with span(self, "upload"):
            return CorpusPlan(
                (buf, doc_ends, parts, ascii_only,
                 torch.from_numpy(buf).to(self.device),
                 torch.from_numpy(doc_ends).to(self.device))
                for buf, doc_ends, parts, ascii_only in chunks
            )

    def _stage_a(self, variant: str, divs, buf_dev, doc_ends_dev):
        self.stage_a_runs += 1
        t = self.tables
        return stage4.stage_a_v4(
            buf_dev, doc_ends_dev, t.class_table, self.pattern, t.word_rows,
            t.word_mask, variant=variant, piece_div=divs[0], miss_div=divs[1],
        )

    def _merge_bucket(self, buf_dev, t, b: int, lanes: int, cap: int, count_b,
                      rounds=None):
        """Stage B for bucket ``b`` of piece table ``t``
        (:func:`pipeline.merge_bucket_v3`).

        ``rounds=None`` is the cold form (its exit tests are host reads,
        counted in ``ops/merge`` where they are read); ``merge.DEVICE`` the
        device form; else what a cold call returned last. Returns (cols, ids,
        active, rounds run: an int, or a 0-d int32 tensor in the device
        form).
        """
        T = self.tables
        tests, rounds_before = merge.EXIT_TESTS, merge.MERGE_ROUNDS
        launches = merge.KERNEL_LAUNCHES
        out = pipeline.merge_bucket_v3(
            buf_dev, t.starts, t.lens, t.miss_sorted, t.group_start[b],
            count_b, T.byte_to_id, T.byte_pair_id, T.pair_rows_cat,
            T.table_mask, lanes=lanes, cap=cap, rounds=rounds,
        )
        self.host_reads += merge.EXIT_TESTS - tests
        self.merge_rounds += merge.MERGE_ROUNDS - rounds_before
        self.merge_kernel_runs += merge.KERNEL_LAUNCHES - launches
        return out

    def _stages_b_c(self, buf_dev, de_dev, t, caps, rounds, want_tokens: bool,
                    want_doc_counts: bool):
        """Stage B over the buckets of ``caps`` ((b, lanes, cap, live count:
        an int or a 0-d device tensor) per bucket) and Stage C for one chunk.
        ``rounds``: None (cold), ``merge.DEVICE``, or per bucket what a cold
        pass returned.

        Returns (tokens or None, n_tokens, doc_counts or None, rounds run
        per bucket), all but the last on the device.
        """
        counts = pipeline.counts_init(t.hit, t.n_pieces)
        bucket_outs, ran = [], []
        for k, (b, lanes, cap, cnt) in enumerate(caps):
            cols, ids, active, r = self._merge_bucket(
                buf_dev, t, b, lanes, cap, cnt,
                rounds if rounds is None or rounds == merge.DEVICE else rounds[k],
            )
            ran.append(r)
            counts = pipeline.counts_add_bucket(counts, cols, active)
            bucket_outs.append((cols, ids, active))
        offsets, n_tokens = pipeline.make_offsets(counts, t.n_pieces)
        tokens = None
        if want_tokens:
            tokens = pipeline.scatter_hits(
                buf_dev.shape[0], t.hit, offsets, t.n_pieces
            )
            for cols, ids, active in bucket_outs:
                tokens = pipeline.scatter_bucket(tokens, ids, active, cols, offsets)
        doc_counts = None
        if want_doc_counts:
            doc_counts = stage4.doc_token_counts_v4(
                offsets, n_tokens, t.starts, de_dev, t.n_pieces
            )
        return tokens, n_tokens, doc_counts, ran

    def _chunk_body(self, plan: CorpusPlan, oki: int, c, buf_dev, de_dev,
                    want_tokens: bool):
        """One ok-chunk of the steady state (ok-chunk ``oki`` of a warmed
        plan, cache entry ``c``, device buffers ``buf_dev`` and ``de_dev``),
        with no host read: Stage A, the merges at the cached rounds, Stage C
        and, once the plan caches the token counts, the pack for the fetch.
        The warmed encode on CUDA records it as one graph per chunk
        (:class:`EncodeGraph`); elsewhere it runs eagerly.

        Returns (tokens or None, n_tokens, doc_counts or None[, packed
        fetch (:meth:`_pack_fetch`)]), all on the device: the copies to the
        host are the caller's (:meth:`_copy_fetch`), never inside a capture.
        """
        table, _meta = self._stage_a(c["variant"], c["divs"], buf_dev, de_dev)
        # per-doc counts are plan-stable: dispatched only until the first
        # encode pass has fetched and cached them
        tokens, n_tokens, doc_counts, _ran = self._stages_b_c(
            buf_dev, de_dev, table, c["caps"], c["rounds"], want_tokens,
            want_tokens and plan.doc_counts is None,
        )
        out = (tokens, n_tokens, doc_counts)
        if want_tokens and plan.n_tokens is not None:
            out += (self._pack_fetch(tokens, plan.n_tokens[oki]),)
        return out

    def _process_chunks_cached(self, plan: CorpusPlan, want_tokens: bool,
                               fetch: bool = True):
        """Steady-state pipeline: every chunk's stages dispatched back to
        back from the plan's cached routing, capacities and round counts,
        with no host read at all.

        With cached token counts the pack and the device-to-host copy of each
        chunk's tokens are issued inside the dispatch, right after the
        chunk's scatters, so the copies run beside the later chunks' kernels.
        ok results then carry a sixth entry, the fetch in flight
        (``fetch=False`` starts no copy and leaves it out).

        On CUDA, an encode over a plan whose caches are complete (routing,
        token and document counts) is one graph replay per ok-chunk
        (:meth:`_encode_graphs`); the results' device tensors are then the
        graphs' outputs, valid until the plan's next encode pass.
        """
        with span(self, "cached_dispatch"):
            if not (want_tokens and self._replays_encode(plan)):
                return self._dispatch_eager(plan, want_tokens, fetch)
            graphs = iter(self._encode_graphs(plan))
            results = []
            for (buf, doc_ends, parts, *_dev), c in zip(plan, plan.chunk_cache):
                if c["kind"] != "ok":
                    self._count_route(c["kind"])
                    results.append((c["kind"], buf, doc_ends, parts))
                    continue
                g = next(graphs)
                *out, packed = self._replay(g)
                if fetch:
                    out.append(self._copy_fetch(plan.pinned, g.oki, packed))
                results.append(("ok", parts, *out))
            return results

    def _dispatch_eager(self, plan: CorpusPlan, want_tokens: bool,
                        fetch: bool = True):
        """The cached dispatch with every op issued eagerly: the body of
        each ok-chunk (:meth:`_chunk_body`), in plan order."""
        results = []
        oki = 0
        for (buf, doc_ends, parts, _a, buf_dev, de_dev), c in zip(
            plan, plan.chunk_cache
        ):
            if c["kind"] != "ok":
                self._count_route(c["kind"])
                results.append((c["kind"], buf, doc_ends, parts))
                continue
            out = self._chunk_body(plan, oki, c, buf_dev, de_dev, want_tokens)
            if len(out) > 3:
                *out, packed = out
                if fetch:
                    out.append(self._copy_fetch(plan.pinned, oki, packed))
            results.append(("ok", parts, *out))
            oki += 1
        return results

    def _process_chunks(self, texts, want_tokens: bool, plan=None):
        """Run the staged pipeline over all chunks with one batched host
        read for the Stage A metadata (plus one on a capacity retry). With a
        warmed plan (``plan.chunk_cache`` set by an earlier pass) nothing is
        read: see :meth:`_process_chunks_cached`. Without a plan each
        chunk's Stage A is issued as soon as the chunk is packed
        (:meth:`_stream_stage_a`).

        With ``cold_cache`` (the default on CUDA) each chunk's Stage A, and
        its Stages B and C with their merges in the device form, are
        replays from the engine's graph cache (:meth:`_cold_stage_a`,
        :meth:`_cold_stages_b_c`); the rounds of those merges come back in
        ``results.pending`` for the caller's last read. Without it every op
        is issued eagerly and each bucket's merge reads its rounds back (on
        the CPU, its exit test after every round).

        Returns a :class:`ChunkResults`, one result per chunk: ("ok", parts,
        tokens, n_tokens, doc_counts) with device tensors, or ("fallback" or
        "native", buf, doc_ends, parts).
        """
        if getattr(plan, "chunk_cache", None) is not None:
            return ChunkResults(self._process_chunks_cached(plan, want_tokens))
        if plan is None:
            staged, metas = self._stream_stage_a(texts)
        else:
            with span(self, "stage_a"):
                staged = [self._stage_chunk(*entry) for entry in plan]
                metas = self._read_metas(staged) if staged else None
        if not staged:
            return ChunkResults()
        with span(self, "stages_b_c"):
            results, cache = self._run_stages_b_c(staged, metas, want_tokens)
        if isinstance(plan, CorpusPlan):
            plan.chunk_cache = cache
        return results

    def _stream_stage_a(self, texts):
        """The un-planned call's chunks packed, uploaded and their Stage A
        issued one by one, so the card runs a chunk's Stage A while the host
        packs the next (``streamed_chunks`` counts the chunks issued before
        the last was packed); then the metas read (:meth:`_read_metas`),
        in the last chunk's ``stage_a`` span. On CUDA the packer writes each
        chunk into pinned blocks of PyTorch's caching host allocator (which
        does not hand a block out again before the copy that reads it has
        run), and the uploads copy from them without a wait: an upload that
        synchronised would wait for the Stage A issued before it. Returns
        (the staged chunks, their metas; None for an empty batch)."""
        chunks = self._chunks(texts, pin=self.device.type == "cuda")
        staged = []
        while True:
            with span(self, "plan"):
                step = next(chunks, None)
                if step is None:
                    return staged, None
                buf, doc_ends, parts, ascii_only, last = step
            with span(self, "upload"):
                buf_dev = buf.to(self.device, non_blocking=True)
                de_dev = doc_ends.to(self.device, non_blocking=True)
            with span(self, "stage_a"):
                staged.append(self._stage_chunk(
                    buf.numpy(), doc_ends.numpy(), parts, ascii_only, buf_dev,
                    de_dev))
                if last:
                    return staged, self._read_metas(staged)
            self.streamed_chunks += 1

    def _stage_chunk(self, buf, doc_ends, parts, ascii_only, buf_dev, de_dev):
        """Issue one chunk's Stage A at its primary capacities. Returns its
        staged entry: [buf, doc_ends, parts, variant, piece table, meta,
        buf_dev, de_dev, divs]."""
        s = [buf, doc_ends, parts, "ascii" if ascii_only else "unicode", None,
             None, buf_dev, de_dev, None]
        self.unicode_chunks += not ascii_only
        self._issue_stage_a(s, _DIVS_PRIMARY if ascii_only else _DIVS_PRIMARY_UNICODE)
        return s

    def _issue_stage_a(self, s, divs) -> None:
        """Stage A of staged entry ``s`` at capacity divisors ``divs``, from
        the graph cache with ``cold_cache``, else eagerly; fills the entry's
        table, meta and divs."""
        run = self._cold_stage_a if self.cold_cache else self._stage_a
        s[4], s[5] = run(s[3], divs, s[6], s[7])
        s[8] = divs

    def _read_metas(self, staged):
        """ONE host read of every staged chunk's meta (and a second Stage A
        and read of the chunks whose tables overflowed, in the
        ``capacity_retry`` span). Returns the metas."""
        with span(self, "metas_read"):
            metas = self._read(torch.stack([s[5] for s in staged]))

        # capacity-overflow retries (the roomy variant suffices for any
        # input). A truncated piece table also reads as PIECE_LEN (its last
        # piece runs to the buffer's end), so that bit is trusted only from
        # a run without CAPACITY.
        retried = [i for i in range(len(staged))
                   if int(metas[i][0]) & stage4.OVERFLOW_CAPACITY]
        if not retried:
            return metas
        self.capacity_retries += 1
        self.retried_chunks += len(retried)
        with span(self, "capacity_retry"):
            for i in retried:
                self._issue_stage_a(staged[i], _DIVS_ROOMY)
            with span(self, "metas_read"):
                re_metas = self._read(torch.stack([staged[i][5] for i in retried]))
        for k, i in enumerate(retried):
            metas[i] = re_metas[k]
        return metas

    def _run_stages_b_c(self, staged, metas, want_tokens: bool):
        """Route every staged chunk by its meta and issue Stages B-C of
        those that stay on the device. Returns (a :class:`ChunkResults`,
        the plan's chunk cache entries), one of each per chunk."""
        results = ChunkResults()
        cache = []
        for i, (buf, doc_ends, parts, variant, t, _meta, buf_dev,
                de_dev, divs) in enumerate(staged):
            overflow = int(metas[i][0])
            if overflow & (stage4.OVERFLOW_PIECE_LEN | stage4.OVERFLOW_CAPACITY):
                self.fallback_chunks += 1
                results.append(("fallback", buf, doc_ends, parts))
                cache.append({"kind": "fallback"})
                continue
            bucket_counts = metas[i][2:]
            # the reference's rule: the bucket widths bound the bytes of the
            # pieces over 64 bytes; over a quarter of the chunk, its merge
            # is cheaper on the native engine's heap merge
            long_bytes = sum(
                int(bucket_counts[b]) * w
                for b, w in enumerate(stage4.BUCKET_WIDTHS) if w > 64
            )
            if long_bytes * 4 > len(buf) and self._native_engine() is not None:
                self.native_chunks += 1
                results.append(("native", buf, doc_ends, parts))
                cache.append({"kind": "native"})
                continue
            caps = [
                (b, lanes, self._bucket_cap(len(buf), lanes, int(bucket_counts[b])),
                 int(bucket_counts[b]))
                for b, lanes in enumerate(stage4.BUCKET_WIDTHS)
                if bucket_counts[b]
            ]
            self.miss_pieces += sum(n for _b, _l, _c, n in caps)
            self.pieces += int(metas[i][1])
            entry = {"kind": "ok", "variant": variant, "divs": divs,
                     "caps": caps, "rounds": None}
            if self.cold_cache:
                tokens, n_tokens, doc_counts, counters = self._cold_stages_b_c(
                    variant, divs, buf_dev, de_dev, t, caps, want_tokens
                )
                results.pending.append((entry, counters))
            else:
                tokens, n_tokens, doc_counts, entry["rounds"] = self._stages_b_c(
                    buf_dev, de_dev, t, caps, None, want_tokens, True
                )
            results.append(("ok", parts, tokens, n_tokens, doc_counts))
            cache.append(entry)
        return results, cache

    # ------------------------------------------------------------------
    # the un-planned path's graph cache
    # ------------------------------------------------------------------

    def _cold_run(self, kind: str, key, srcs, record, warm):
        """Run the cached unit ``key`` of cache ``kind`` over ``srcs`` (the
        chunk's input tensors) and return clones of its outputs (None
        entries pass through).

        The inputs are copied into the unit's static inputs. On CUDA a unit
        seen for the first time is captured (:meth:`_capture`, its own
        memory pool; ``warm(unit)`` runs first, eagerly, on the capture
        stream, and its merge rounds are not counted) and every run replays
        it; the least recently used unit past :data:`COLD_CACHE_MAX` is
        dropped with its pools. On a CPU device the recorded body runs
        eagerly.
        """
        cache = self._cold[kind]
        unit = cache.get(key)
        if unit is None:
            unit = cache[key] = ColdUnit(key, [
                torch.empty(x.shape, dtype=x.dtype, device=self.device) for x in srcs
            ])
            while len(cache) > self.COLD_CACHE_MAX:
                cache.popitem(last=False)
        else:
            cache.move_to_end(key)
        for dst, src in zip(unit.inputs, srcs):
            dst.copy_(src)
        if self.device.type != "cuda":
            out = record(unit)
        else:
            if unit.graph is None:
                def warm_once():
                    rounds, mine = merge.MERGE_ROUNDS, self.merge_rounds
                    warm(unit)
                    merge.MERGE_ROUNDS, self.merge_rounds = rounds, mine

                with span(self, "capture") as s:
                    _s, unit.pool_bytes = self._capture(
                        warm_once, [unit], record, shared_pool=False
                    )
                unit.capture_seconds = s.ns / 1e9
                self.cold_captures += 1
            out = self._replay(unit)
        return [None if x is None else x.clone() for x in out]

    def _cold_stage_a(self, variant: str, divs, buf_dev, de_dev):
        """Stage A of one chunk from the cache, keyed by (variant, divs, N,
        D): (piece table, meta) as :meth:`_stage_a` returns them, copies of
        the unit's outputs that the chunk keeps until its Stages B and C."""
        def record(u):
            table, meta = self._stage_a(variant, divs, *u.inputs)
            return tuple(table) + (meta,)

        out = self._cold_run(
            "stage_a", (variant, divs, buf_dev.shape[0], de_dev.shape[0]),
            [buf_dev, de_dev], record, record,
        )
        return stage4.PieceTableV4(*out[:-1]), out[-1]

    def _cold_stages_b_c(self, variant: str, divs, buf_dev, de_dev, t, caps,
                         want_tokens: bool):
        """Stages B and C of one chunk from the cache, keyed by (variant,
        divs, N, D, (b, lanes, cap) per bucket, want_tokens): the live
        counts and the bucket starts come from the piece table on the
        device, so one unit serves every chunk whose counts quantize to the
        same capacities. Its merges run in the device form (``merge.DEVICE``:
        one merge kernel a bucket).

        Returns (tokens or None, n_tokens, doc_counts, int32 round counters
        in bucket order), all on the device.
        """
        sig = tuple((b, lanes, cap) for b, lanes, cap, _n in caps)

        def body(u, rounds):
            buf, de, *fields = u.inputs
            tab = stage4.PieceTableV4(*fields)
            live = [(b, lanes, cap, tab.bucket_counts[b]) for b, lanes, cap in sig]
            return self._stages_b_c(buf, de, tab, live, rounds, want_tokens, True)

        def record(u):
            tokens, n_tokens, doc_counts, ran = body(u, merge.DEVICE)
            counters = (torch.stack(ran) if ran
                        else torch.zeros(0, dtype=torch.int32, device=self.device))
            return tokens, n_tokens, doc_counts, counters

        def warm(u):
            # every op of the body once: one round a bucket
            body(u, [1] * len(sig))

        return self._cold_run(
            "stages_b_c",
            (variant, divs, buf_dev.shape[0], de_dev.shape[0], sig, want_tokens),
            [buf_dev, de_dev, *t], record, warm,
        )

    def cold_cache_stats(self) -> dict:
        """What the un-planned path's caches hold: units (graphs on CUDA)
        and the device memory reserved while they were captured, per cache
        and in all, with the captures made and their seconds since the
        engine was built."""
        units = {k: list(c.values()) for k, c in self._cold.items()}
        out = {k: {"units": len(us), "pool_bytes": sum(u.pool_bytes for u in us)}
               for k, us in units.items()}
        out["units"] = sum(len(us) for us in units.values())
        out["pool_bytes"] = sum(u.pool_bytes for us in units.values() for u in us)
        out["captures"] = self.cold_captures
        out["capture_seconds"] = self.cold_capture_seconds
        return out

    @property
    def cold_capture_seconds(self) -> float:
        """Seconds spent capturing the un-planned path's units: the
        ``capture`` span's total."""
        return self.capture_ns / 1e9

    # ------------------------------------------------------------------
    # the packed token fetch
    # ------------------------------------------------------------------

    @staticmethod
    def _low_halves(t):
        """The low 16 bits of each int32 as int16 words (the bit pattern of
        the reference's uint16): the even halves of the little-endian view,
        so no narrowing conversion is involved."""
        return t.contiguous().view(torch.int16)[0::2].contiguous()

    @staticmethod
    def _bit_plane(t):
        """Bit 16 of each id, 8 ids a byte, lowest bit first."""
        bits = ((t >> 16) & 1).reshape(-1, 8)
        w = torch.arange(8, dtype=torch.int32, device=t.device)
        return (bits << w[None, :]).sum(dim=1).to(torch.uint8)

    def _slice_tokens(self, tokens, pad: int):
        """(lo, hi) of the quantized token prefix ``tokens[:pad]``: 2 bytes a
        token and, where ids need a 17th bit, the 1-bit plane (else None)."""
        t = tokens[:pad]
        return self._low_halves(t), (self._bit_plane(t) if self._fetch_wide else None)

    def _to_host(self, pinned: dict, key, arrays):
        """Start the copies of device ``arrays`` (None entries pass through)
        into pinned host buffers kept under ``key``, without blocking; the
        caller waits once (:meth:`_wait_fetches`) before reading any. CPU
        tensors are returned as they are."""
        if self.device.type != "cuda":
            return list(arrays)
        bufs = pinned.get(key)
        if bufs is None:
            bufs = pinned[key] = [
                None if a is None
                else torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
                for a in arrays
            ]
        for b, a in zip(bufs, arrays):
            if a is not None:
                b.copy_(a, non_blocking=True)
        return bufs

    def _wait_fetches(self) -> None:
        """The one wait of a pass on its token copies (one host read)."""
        self.host_reads += 1
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _pack_fetch(self, tokens, n_tokens: int):
        """A chunk's live token prefix packed for its fetch: None for a chunk
        without tokens, else (pad, (lo, hi)) of :meth:`_slice_tokens` at the
        quantized length ``pad``."""
        if not n_tokens:
            return None
        pad = min(_next_pow2(n_tokens, 8192), tokens.shape[0])
        return pad, self._slice_tokens(tokens, pad)

    def _copy_fetch(self, pinned: dict, oki: int, packed):
        """Start the copies of ok-chunk ``oki``'s :meth:`_pack_fetch` result
        into its pinned buffers. Returns (lo, hi), host tensors that hold
        their data after :meth:`_wait_fetches` (None, None without tokens).
        """
        if packed is None:
            return (None, None)
        pad, arrays = packed
        return tuple(self._to_host(pinned, (oki, pad), arrays))

    @staticmethod
    def _consume_fetch(fetch, n_tokens: int) -> np.ndarray:
        """One chunk's token ids from its fetched (lo, hi): 16-bit low halves
        plus the optional 17th-bit plane (host tensors or numpy arrays)."""
        def host(a):
            return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

        lo, hi = fetch
        if lo is None:
            return np.zeros((0,), np.int32)
        vals = host(lo).view(np.uint16)[:n_tokens].astype(np.int32)
        if hi is not None:
            vals |= np.unpackbits(
                host(hi), bitorder="little"
            )[:n_tokens].astype(np.int32) << 16
        return vals

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
        mask = self._read(boundaries.piece_starts(info, self.pattern))
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

            ids, active = self._merge_flat(mat, blens, len(sel))
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

    def _merge_flat(self, mat: np.ndarray, blens: np.ndarray, n: int):
        """The fallback's merge of one bucket (``mat`` uint8[R, L] rows of
        piece bytes, ``blens`` their lengths, the first ``n`` rows live):
        (ids, active) of those rows on the host. On CUDA the merge is one
        launch of the merge kernel.

        With ``cold_cache`` the merge leaves its rounds on the device and ONE
        read brings back the ids, the active lanes and the rounds; without
        it the merge reads its rounds back first (on the CPU: each exit
        test).
        """
        t = self.tables
        args = (t.byte_to_id, t.byte_pair_id, t.pair_rows_cat, t.table_mask)
        mat_dev, lens_dev = (torch.from_numpy(x).to(self.device) for x in (mat, blens))
        tests, launches = merge.EXIT_TESTS, merge.KERNEL_LAUNCHES
        if not self.cold_cache:
            ids, active, ran = merge.merge_rows(mat_dev, lens_dev, *args)
            self.host_reads += merge.EXIT_TESTS - tests
            self.merge_rounds += ran
            self.merge_kernel_runs += merge.KERNEL_LAUNCHES - launches
            return self._read(ids[:n]), self._read(active[:n])
        ids, active, rounds = merge.merge_rows(mat_dev, lens_dev, *args, rounds=merge.DEVICE)
        # the plain version's exit tests (a CPU device); none on CUDA
        self.host_reads += merge.EXIT_TESTS - tests
        self.merge_kernel_runs += merge.KERNEL_LAUNCHES - launches
        L = mat.shape[1]
        host = self._read(torch.cat([
            ids[:n].reshape(-1), active[:n].reshape(-1).to(torch.int32),
            rounds.reshape(1),
        ]))
        merge.MERGE_ROUNDS += int(host[-1])
        self.merge_rounds += int(host[-1])
        return host[: n * L].reshape(n, L), host[n * L : 2 * n * L].reshape(n, L) != 0

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
    # chunks off the staged path: the native engine and the fallback
    # ------------------------------------------------------------------

    def _count_route(self, kind: str) -> None:
        if kind == "native":
            self.native_chunks += 1
        else:
            self.fallback_chunks += 1

    @staticmethod
    def _encode_chunk_native(nat, buf, doc_ends, parts):
        """[(doc_idx, int32 tokens)] of one chunk through the native engine,
        one entry per nonempty chunk-document in order."""
        out = []
        prev = 0
        for k, doc_idx in enumerate(parts):
            end = int(doc_ends[k])
            start = prev if k == 0 else prev + 1
            if end > start:
                out.append((doc_idx, nat.encode_bytes(buf[start:end])))
            prev = end
        return out

    def _run_host_chunks(self, results):
        """Token lists of every result that left the staged path:
        {result index: [(doc_idx, int32 tokens)] in the chunk's document
        order}. Native chunks run on a thread pool (the C calls release the
        GIL) while the fallback chunks run here; callers consume the lists in
        result order, so a document spanning device and host chunks keeps
        its token order."""
        if all(r[0] not in ("native", "fallback") for r in results):
            return {}
        natives = [i for i, r in enumerate(results) if r[0] == "native"]
        out = {}
        with span(self, "host_chunks"), ThreadPoolExecutor(
            max(1, min(len(natives), os.cpu_count() or 2))
        ) as pool:
            if natives:
                nat = self._native_engine()
                futures = {
                    i: pool.submit(self._encode_chunk_native, nat, *results[i][1:])
                    for i in natives
                }
            for i, r in enumerate(results):
                if r[0] == "fallback":
                    out[i] = self._encode_chunk_fallback(*r[1:])
            with span(self, "native_wait"):
                for i in natives:
                    out[i] = futures[i].result()
        return out

    # ------------------------------------------------------------------
    # public batch API
    # ------------------------------------------------------------------

    def encode_ordinary_batch_arrays(
        self, texts: Sequence[Optional[str]], plan=None
    ) -> List[np.ndarray]:
        """Token ids per document as int32 numpy arrays.

        Cold pass: ONE fetch of every chunk's (n_tokens, doc_counts), then
        each chunk's live token prefix is sliced to a quantized length,
        packed and copied to pinned host memory without blocking, and ONE
        wait precedes the first consume. Over a warmed :class:`CorpusPlan`
        the counts are cached and the copies were started inside the
        dispatch (on CUDA, right after each chunk's graph replay), so the
        wait is the pass's only host read.
        """
        if texts is None and plan is None:
            return []
        with span(self, "encode"):
            is_plan = isinstance(plan, CorpusPlan)
            # as it stood before this pass: a pass that finds the counts
            # cached has its fetches in flight already
            cached = is_plan and plan.n_tokens is not None
            results = self._process_chunks(texts, want_tokens=True, plan=plan)
            ok = [r for r in results if r[0] == "ok"]
            if ok and not cached:
                # sync round 2a: ONE fetch of every chunk's n_tokens, then
                # every chunk's doc_counts. Both are plan-stable, so a warmed
                # plan skips it.
                with span(self, "counts_read"):
                    small = self._read(self._pack_metas(
                        [r[3] for r in ok], [r[4] for r in ok]
                    ), results.pending)
                    n_tokens = [int(x) for x in small[: len(ok)]]
                    doc_counts = []
                    pos = len(ok)
                    for r in ok:
                        doc_counts.append(small[pos : pos + len(r[1])])
                        pos += int(r[4].shape[0])
                if is_plan:
                    plan.n_tokens, plan.doc_counts = n_tokens, doc_counts
            elif ok:
                n_tokens, doc_counts = plan.n_tokens, plan.doc_counts
            # start every chunk's packed copy before consuming any
            pinned = plan.pinned if is_plan else {}
            with span(self, "fetch"):
                fetches = [
                    r[5] if len(r) > 5
                    else self._copy_fetch(pinned, k, self._pack_fetch(r[2], n_tokens[k]))
                    for k, r in enumerate(ok)
                ]
            host = self._run_host_chunks(results)
            if ok:
                with span(self, "fetch_wait"):
                    self._wait_fetches()
            with span(self, "unpack_split"):
                n_docs = (
                    len(texts) if texts is not None
                    else 1 + max(p for entry in plan for p in entry[2])
                )
                parts_out: List[List[np.ndarray]] = [[] for _ in range(n_docs)]
                oki = 0
                for ri, res in enumerate(results):
                    if res[0] != "ok":
                        for doc_idx, toks in host[ri]:
                            parts_out[doc_idx].append(toks)
                        continue
                    parts = res[1]
                    tokens = self._consume_fetch(fetches[oki], n_tokens[oki])
                    splits = np.cumsum(doc_counts[oki][: len(parts)])[:-1]
                    for doc_idx, toks in zip(parts, np.split(tokens, splits)):
                        parts_out[doc_idx].append(toks)
                    oki += 1
                empty = np.zeros((0,), np.int32)
                return [
                    ps[0] if len(ps) == 1
                    else (np.concatenate(ps) if ps else empty)
                    for ps in parts_out
                ]

    def encode_plan_tokens(self, plan: CorpusPlan) -> torch.Tensor:
        """The warmed encode kept on the device: every token id of the plan's
        documents, in document order, as ONE int32 tensor on the engine's
        device (the documents' counts are those of the pass that cached the
        plan's token counts).

        The plan must have had its first encode pass
        (:meth:`encode_ordinary_batch_arrays`, which caches the token and
        document counts). The cached dispatch runs (on CUDA one graph replay
        per ok-chunk), no copy to the host is started and nothing is read
        back: the chunks' live token prefixes and the host-routed chunks'
        tokens (native, fallback; one host-to-device copy) are joined by one
        ``torch.cat``. The tensor is the caller's, not a graph output.
        """
        if plan.chunk_cache is None or (
            plan.n_tokens is None
            and any(c["kind"] == "ok" for c in plan.chunk_cache)
        ):
            raise ValueError("encode_plan_tokens needs a plan whose first encode "
                             "pass has run")
        results = self._process_chunks_cached(plan, True, fetch=False)
        host = self._run_host_chunks(results)
        # every host chunk's tokens, in result order, in one array
        host_lists = [toks for ri in sorted(host) for _d, toks in host[ri]]
        host_dev = self._upload(
            np.concatenate(host_lists).astype(np.int32, copy=False)
        ) if host_lists else None
        segments = []
        oki = pos = 0
        for ri, res in enumerate(results):
            if res[0] == "ok":
                n = plan.n_tokens[oki]
                oki += 1
                if n:
                    segments.append(res[2][:n])
                continue
            n = sum(len(toks) for _d, toks in host[ri])
            if n:
                segments.append(host_dev[pos : pos + n])
                pos += n
        if not segments:
            return torch.zeros(0, dtype=torch.int32, device=self.device)
        return torch.cat(segments)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device, copied without a wait (from
        pinned memory) on CUDA. The pinned block comes from PyTorch's
        caching host allocator, which does not hand it out again before the
        copy that reads it has run; numpy fills it (``Tensor.pin_memory()``
        took 1.5-3 times as long on the card's host)."""
        t = torch.from_numpy(arr)
        if self.device.type != "cuda":
            return t.to(self.device)
        pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        pinned.numpy()[...] = arr
        return pinned.to(self.device, non_blocking=True)

    @staticmethod
    def _pack_metas(ns, dcs):
        """All chunks' n_tokens, then all their doc_counts, as one tensor."""
        return torch.cat([torch.stack(ns)] + list(dcs))

    def encode_ordinary_batch(
        self, texts: Sequence[Optional[str]]
    ) -> List[List[int]]:
        if not texts:
            return []
        return [a.tolist() for a in self.encode_ordinary_batch_arrays(texts)]

    def count_tokens_batch(self, texts: Sequence[Optional[str]]) -> List[int]:
        if not texts:
            return []
        with span(self, "count"):
            counts = [0] * len(texts)
            results = self._process_chunks(texts, want_tokens=False)
            ok = [r for r in results if r[0] == "ok"]
            if ok:
                with span(self, "counts_read"):
                    small = self._read(torch.cat([r[4] for r in ok]), results.pending)
            host = self._run_host_chunks(results)
            pos = 0
            for ri, res in enumerate(results):
                if res[0] != "ok":
                    for doc_idx, toks in host[ri]:
                        counts[doc_idx] += len(toks)
                    continue
                parts, doc_counts_dev = res[1], res[4]
                for doc_idx, c in zip(parts, small[pos : pos + len(parts)]):
                    counts[doc_idx] += int(c)
                pos += int(doc_counts_dev.shape[0])
            return counts

    # ------------------------------------------------------------------
    # corpus count: the mapped count over a warmed plan
    # ------------------------------------------------------------------

    def _count_body(self, variant, divs, sig, buf, doc_ends):
        """One chunk's token count (0-d tensor): Stage A, every merge bucket
        of ``sig`` ((b, lanes, cap, rounds) per bucket) and the offsets,
        with the bucket counts taken from the device and nothing read
        back."""
        table, _meta = self._stage_a(variant, divs, buf, doc_ends)
        counts = pipeline.counts_init(table.hit, table.n_pieces)
        for (b, lanes, cap, rounds) in sig:
            cols, _ids, active, _ran = self._merge_bucket(
                buf, table, b, lanes, cap, table.bucket_counts[b], rounds
            )
            counts = pipeline.counts_add_bucket(counts, cols, active)
        _offsets, n_tokens = pipeline.make_offsets(counts, table.n_pieces)
        return n_tokens

    def _block_sum(self, blk: CountBlock):
        return torch.stack([
            self._count_body(blk.variant, blk.divs, blk.sig, b, d)
            for b, d in zip(blk.bufs, blk.des)
        ]).sum()

    def _mapped_count_groups(self, plan: CorpusPlan):
        """Group a warmed plan's ok-chunks by shape into the blocks of the
        mapped count, and on CUDA capture each block as one graph.

        Groups are keyed by (variant, divs, flat size, doc slots); a group's
        signature is the per-bucket MAX of capacity and of merge rounds over
        its chunks (capacities are quantized to powers of two, so the union
        normally equals every chunk's own; a larger capacity adds dead
        columns and more rounds add no-op rounds). Each group is split into
        blocks of 8 chunks and one remainder padded to a power of two with
        all-zero chunks, which classify to zero pieces and count zero
        tokens.
        """
        if plan.mapped_count is not None:
            return plan.mapped_count
        bykey = {}
        blocks = []
        for entry, c in zip(plan, plan.chunk_cache):
            if c["kind"] != "ok":
                continue
            buf, doc_ends, _parts, _a, buf_dev, de_dev = entry
            key = (c["variant"], c["divs"], len(buf), doc_ends.shape[0])
            bykey.setdefault(key, []).append((buf_dev, de_dev, c))
        for (variant, divs, N, D), items in bykey.items():
            by_bucket = {}
            for _b, _d, c in items:
                for (b, lanes, cap, _cnt), r in zip(c["caps"], c["rounds"]):
                    cap0, r0 = by_bucket.get((b, lanes), (0, 0))
                    by_bucket[(b, lanes)] = (max(cap0, cap), max(r0, r))
            sig = tuple(
                (b, lanes, cap, r)
                for (b, lanes), (cap, r) in sorted(by_bucket.items())
            )
            zero_buf = torch.zeros(N, dtype=torch.uint8, device=self.device)
            zero_de = torch.zeros(D, dtype=torch.int32, device=self.device)
            n = len(items)
            sizes = [8] * (n // 8)
            if n % 8:
                sizes.append(_next_pow2(n % 8))
            pos = 0
            for C in sizes:
                sub = items[pos : pos + C]
                pos += C
                pad = C - len(sub)
                blocks.append(CountBlock(
                    variant, divs, sig,
                    [b for b, _d, _c in sub] + [zero_buf] * pad,
                    [d for _b, d, _c in sub] + [zero_de] * pad,
                    len(sub),
                ))
        if self.device.type == "cuda" and blocks:
            self._capture_blocks(plan, blocks)
        plan.mapped_count = blocks
        return blocks

    def _capture_blocks(self, plan: CorpusPlan, blocks) -> None:
        """Capture every block of the mapped count as one graph
        (:meth:`_capture`). Before the captures, one chunk of every shape
        (signature, flat size and document slots) runs eagerly with one
        merge round a bucket."""
        def warm():
            shapes = {
                (b.variant, b.divs, b.sig, b.bufs[0].shape[0], b.des[0].shape[0]): b
                for b in blocks
            }
            for blk in shapes.values():
                once = tuple((b, lanes, cap, min(r, 1)) for b, lanes, cap, r in blk.sig)
                self._count_body(blk.variant, blk.divs, once, blk.bufs[0], blk.des[0])

        plan.capture_seconds, plan.graph_pool_bytes = self._capture(
            warm, blocks, self._block_sum
        )

    def _capture(self, warm, units, record, shared_pool: bool = True):
        """Capture ``record(unit)`` for every unit as one
        ``torch.cuda.CUDAGraph``, whose outputs become ``unit.out``, all on
        the engine's capture stream. With ``shared_pool`` (a plan's graphs,
        replayed in capture order) they share one memory pool, and the
        plan's device buffers are the graphs' inputs where they lie
        (immutable and resident), so a replay copies nothing in. Without it
        (the un-planned path's cache, replayed in any order) each graph has
        a pool of its own, and the capture neither synchronises the card nor
        flushes the allocators' caches as ``torch.cuda.graph`` does. A
        capture that fails raises.

        ``warm()`` runs first, eagerly on the capture stream: it must make
        the scan kernel's scratch for that stream at its full size (the
        scratch must not be made during a capture; it lives in
        ``scan.SCRATCH`` as long as the process) and load every kernel the
        recording launches. What a recording adds to the engine's counters
        (Stage A runs, merge rounds) was recorded, not run: the counters are
        restored, and the unit keeps its scans, rounds and merge kernel
        launches.

        Returns (seconds spent, bytes reserved while capturing).
        """
        if not units:
            return 0.0, 0
        dev = self.device
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(dev)
        stream = self._capture_stream
        t0 = time.time()
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            warm()
        stream.synchronize()
        pool = None
        if shared_pool:
            # entering a capture empties the allocator's cache; done here
            # first, what is reserved from now on is the graphs' pool
            t = time.time()
            torch.cuda.empty_cache()
            self.empty_cache_seconds += time.time() - t
            pool = torch.cuda.graph_pool_handle()
        reserved = torch.cuda.memory_reserved(dev)
        for u in units:
            scans, rounds = scan.CAPTURED_CALLS, merge.MERGE_ROUNDS
            merges = merge.CAPTURED_CALLS
            runs, mine = self.stage_a_runs, self.merge_rounds
            graph = torch.cuda.CUDAGraph()
            if shared_pool:
                with torch.cuda.graph(graph, pool=pool, stream=stream):
                    u.out = record(u)
            else:
                with torch.cuda.stream(stream):
                    graph.capture_begin()
                    try:
                        u.out = record(u)
                    finally:
                        graph.capture_end()
            u.graph = graph
            u.n_scans = scan.CAPTURED_CALLS - scans
            u.n_rounds = merge.MERGE_ROUNDS - rounds
            u.n_merge_kernels = merge.CAPTURED_CALLS - merges
            # recorded, not run
            self.stage_a_runs, self.merge_rounds = runs, mine
            merge.MERGE_ROUNDS = rounds
        return time.time() - t0, torch.cuda.memory_reserved(dev) - reserved

    def _replay(self, unit: _Captured):
        """Replay a unit's graph on the current stream; returns its outputs.
        The scans it recorded are accounted first (``scan.count_replay``),
        its merge kernel launches after (``merge_kernel_runs``)."""
        scan.count_replay(self.device, self._capture_stream.cuda_stream, unit.n_scans)
        unit.graph.replay()
        self.graph_replays += 1
        self.merge_kernel_runs += unit.n_merge_kernels
        return unit.out

    def _run_block(self, blk: CountBlock):
        """The block's token total (0-d tensor): a graph replay on CUDA, the
        eager body on a CPU device."""
        if blk.graph is None:
            if self.device.type == "cuda":
                raise RuntimeError("a block of the mapped count has no graph")
            return self._block_sum(blk)
        return self._replay(blk)

    def _replays_encode(self, plan: CorpusPlan) -> bool:
        """Whether the plan's encode runs as graph replays: on CUDA, once
        every cache of the plan is set."""
        return (
            self.device.type == "cuda" and plan.n_tokens is not None
            and plan.doc_counts is not None
        )

    def _encode_graphs(self, plan: CorpusPlan):
        """The plan's encode graphs, one per ok-chunk, captured at the first
        call: the eager cached dispatch runs once on the capture stream
        first (the scan scratch at every shape of the body, and each chunk's
        pinned buffers, which the copies after every replay reuse), then
        each chunk's body is recorded."""
        if plan.encode_graphs is None:
            ok = [(e, c) for e, c in zip(plan, plan.chunk_cache) if c["kind"] == "ok"]
            units = [EncodeGraph(k, c, e[4], e[5]) for k, (e, c) in enumerate(ok)]
            plan.encode_capture_seconds, plan.encode_pool_bytes = self._capture(
                lambda: self._dispatch_eager(plan, True),
                units,
                lambda u: self._chunk_body(plan, u.oki, u.c, u.buf_dev, u.de_dev, True),
            )
            plan.encode_graphs = units
        return plan.encode_graphs

    def count_tokens_corpus(self, texts: Sequence[Optional[str]], plan=None) -> int:
        """Total token count of a corpus.

        Over a warmed :class:`CorpusPlan` this is the mapped count: one graph
        replay per block of up to 8 chunks and ONE scalar fetch per pass; chunks routed to
        the native engine or the long-piece fallback keep their path.
        """
        dev_total, host_total, pending = self._count_parts(texts, plan)
        if dev_total is None:
            return host_total
        return int(self._read(dev_total, pending)) + host_total

    def _count_parts(self, texts, plan):
        """(the device chunks' total as a 0-d int64 tensor on the device or
        None, the host chunks' total as an int, the cold pass's pending round
        counters to read with the total: see :class:`ChunkResults`), nothing
        of the first read back."""
        if isinstance(plan, CorpusPlan) and plan.chunk_cache is not None:
            sums = [self._run_block(blk) for blk in self._mapped_count_groups(plan)]
            results = ChunkResults(
                (c["kind"], e[0], e[1], e[2])
                for e, c in zip(plan, plan.chunk_cache) if c["kind"] != "ok"
            )
            for r in results:
                self._count_route(r[0])
        else:
            results = self._process_chunks(texts, want_tokens=False, plan=plan)
            sums = [r[3] for r in results if r[0] == "ok"]
        dev_total = torch.stack(sums).sum().to(torch.int64) if sums else None
        host_total = sum(
            len(toks) for lists in self._run_host_chunks(results).values()
            for _d, toks in lists
        )
        return dev_total, host_total, results.pending

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
            # the live prefix: the byte count is known on the host and
            # nothing is compiled per length here, so it is exact, not
            # quantized
            data = self._read(data_dev[:total_bytes]).tobytes()
        return self._cut_lists(out, data, byte_ends, splits)

    def decode_bytes_batch(self, token_lists) -> List[bytes]:
        return self.decode_bytes_batch_device(token_lists)


def _maybe_asset_path(name: str):
    try:
        return asset_path(name)
    except Exception:
        return None
