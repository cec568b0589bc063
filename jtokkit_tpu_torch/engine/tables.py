"""The device-resident tables of one encoding.

Counterpart of the tables ``jtokkit_tpu/engine/device.py`` builds in
``DeviceEngine.__init__``: the packed class table, the byte and byte-pair
seed tables, the stacked cuckoo pair rows, the two word-table halves and the
decode pool (the reference's ``byte_pair_seed``, read only by its wide-bucket
merge, has no counterpart here). :meth:`DeviceTables.from_numpy` takes the same arrays as numpy
(for example the JAX engine's, converted with ``np.asarray``), so a test can
feed both engines identical state.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from ..ops import classify
from ..vocab.tables import PackedVocabulary

ARRAY_NAMES = (
    "class_table", "byte_to_id", "byte_pair_id", "pair_rows_cat",
    "word_rows_cat", "token_offsets", "token_bytes",
)


def packed_arrays(packed: PackedVocabulary) -> Dict[str, np.ndarray]:
    """The numpy arrays of :data:`ARRAY_NAMES` for one packed vocabulary."""
    # cuckoo pair rows (u, v, id, safe); the two tables stacked along rows
    pair_rows = [
        np.stack([packed.cuckoo_u[t], packed.cuckoo_v[t], packed.cuckoo_id[t],
                  packed.cuckoo_safe[t]], axis=1)
        for t in (0, 1)
    ]
    word_lenid = np.where(
        packed.word_len < 0, -1, (packed.word_len << 20) | packed.word_id
    ).astype(np.int32)
    zeros = np.zeros_like(packed.word_w0[0])
    # word rows (w0..w3, len<<20|id, pad x3): one 16-byte-token entry per row
    word_rows = np.concatenate([
        np.stack([packed.word_w0[t], packed.word_w1[t], packed.word_w2[t],
                  packed.word_w3[t], word_lenid[t], zeros, zeros, zeros],
                 axis=1)
        for t in (0, 1)
    ], axis=0)
    return {
        "class_table": classify.packed_class_table_array(),
        "byte_to_id": packed.byte_to_id,
        "byte_pair_id": packed.byte_pair_id,
        "pair_rows_cat": np.concatenate(pair_rows, axis=0),
        "word_rows_cat": word_rows,
        "token_offsets": packed.token_offsets,
        "token_bytes": packed.token_bytes,
    }


@dataclass
class DeviceTables:
    """One encoding's tables as tensors on one device."""

    device: torch.device
    class_table: torch.Tensor     # int32[111412] classes, 10 per word
    byte_to_id: torch.Tensor      # int32[256]
    byte_pair_id: torch.Tensor    # int32[65536]
    pair_rows_cat: torch.Tensor   # int32[2T, 4]
    word_rows: Tuple[torch.Tensor, torch.Tensor]  # two int32[S, 8] halves
    token_offsets: torch.Tensor   # int32[n_tokens + 1]
    token_bytes: torch.Tensor     # uint8[pool]
    table_mask: int
    word_mask: int

    @classmethod
    def from_numpy(cls, arrays: Dict[str, np.ndarray], device) -> "DeviceTables":
        device = torch.device(device)
        t = {
            k: torch.tensor(np.asarray(arrays[k]), device=device)
            for k in ARRAY_NAMES
        }
        pair_rows = t["pair_rows_cat"]
        word_rows = t["word_rows_cat"]
        S = word_rows.shape[0] // 2
        return cls(
            device=device,
            class_table=t["class_table"],
            byte_to_id=t["byte_to_id"],
            byte_pair_id=t["byte_pair_id"],
            pair_rows_cat=pair_rows,
            word_rows=(word_rows[:S].contiguous(), word_rows[S:].contiguous()),
            token_offsets=t["token_offsets"],
            token_bytes=t["token_bytes"],
            table_mask=pair_rows.shape[0] // 2 - 1,
            word_mask=S - 1,
        )

    @classmethod
    def from_packed(cls, packed: PackedVocabulary, device) -> "DeviceTables":
        return cls.from_numpy(packed_arrays(packed), device)
