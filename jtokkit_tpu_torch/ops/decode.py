"""Device decode: token ids -> UTF-8 bytes as a gather over the packed
token-byte pool.

Counterpart of ``jtokkit_tpu/ops/decode.py``. The reference decode walks a
reverse map per token (``M/GptBytePairEncoding.java:137-151``); here every
output byte is produced in parallel: each token's ordinal is scattered at its
output start position, a running maximum fills the span (the scan kernel of
:mod:`.scan` on the card, at one leaf), and one gather reads the byte pool.
"""

from __future__ import annotations

import torch

from . import scan


def decode_tokens(tokens, n_tokens, token_offsets, token_bytes, out_capacity: int):
    """Bytes of a token stream.

    Args:
      tokens: int32[T] token ids; -1 is padding.
      n_tokens: number of leading tokens that count (int or scalar tensor).
      token_offsets: int32[V + 1] start of each token in the pool.
      token_bytes: uint8[pool].
      out_capacity: size of the output buffer.

    Returns (out uint8[out_capacity], n_bytes int32 scalar). Ids outside the
    vocabulary (special tokens) are zero-length here; the caller handles
    them.
    """
    T = tokens.shape[0]
    V = token_offsets.shape[0] - 1
    dev = tokens.device
    if T == 0:
        return (torch.zeros(out_capacity, dtype=torch.uint8, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    t_iota = torch.arange(T, dtype=torch.int32, device=dev)
    tok_valid = (t_iota < n_tokens) & (tokens >= 0) & (tokens < V)
    safe_ids = tokens.clamp(0, V - 1)
    pool_start = token_offsets.index_select(0, safe_ids)
    lens = torch.where(
        tok_valid, token_offsets.index_select(0, safe_ids + 1) - pool_start, 0
    )
    ends = torch.cumsum(lens, 0, dtype=torch.int32)
    n_bytes = ends[T - 1]
    starts = ends - lens
    # pool index of output byte p from token t is pool_start[t] + (p -
    # starts[t]); both per-token terms fold into one value
    adj = pool_start - starts

    # source token per output byte: each token of length > 0 marks its start
    # position with its ordinal, then the running maximum fills the span.
    # Zero-length and invalid tokens, and starts past the capacity, aim at a
    # spare slot one past the end, which is cut off.
    tgt = torch.where(tok_valid & (lens > 0), starts, out_capacity)
    tgt = tgt.clamp(max=out_capacity).to(torch.int64)
    marks = torch.full((out_capacity + 1,), -1, dtype=torch.int32, device=dev)
    marks.scatter_reduce_(0, tgt, t_iota, "amax")
    (src_tok,) = scan.scan_leaves([marks[:out_capacity]], ["max"])
    src_tok = src_tok.clamp(0, T - 1)

    pos = torch.arange(out_capacity, dtype=torch.int32, device=dev)
    pool_idx = adj.index_select(0, src_tok) + pos
    pool_idx = pool_idx.clamp(0, token_bytes.shape[0] - 1)
    out = torch.where(pos < n_bytes, token_bytes.index_select(0, pool_idx), 0)
    return out, n_bytes
