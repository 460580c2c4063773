"""Token-sequence rendering (echr_tpu/utils/text.py; reference:
misc/utils.py:24-38), the port's numpy copy."""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

# vocab dict -> id-to-word table, keyed by identity; a few vocabs at most
_TABLE_CACHE: Dict[int, Tuple[Dict[str, str], np.ndarray]] = {}
_TABLE_CACHE_MAX = 8


def _table(ix_to_word: Dict[str, str]) -> np.ndarray:
    key = id(ix_to_word)
    hit = _TABLE_CACHE.get(key)
    if hit is not None and hit[0] is ix_to_word:  # id() may be reused after eviction
        return hit[1]
    size = max((int(k) for k in ix_to_word), default=0) + 1
    table = np.empty(size, dtype=object)
    table[:] = ""
    for k, w in ix_to_word.items():
        table[int(k)] = w
    while len(_TABLE_CACHE) >= _TABLE_CACHE_MAX:
        _TABLE_CACHE.pop(next(iter(_TABLE_CACHE)))
    _TABLE_CACHE[key] = (ix_to_word, table)
    return table


def decode_sequence(ix_to_word: Dict[str, str], seq: np.ndarray) -> List[str]:
    """Token ids [n, L] (or [L]) -> sentences.  A row stops at its first
    id <= 0 (0 is END); ids past the vocab render as nothing."""
    seq = np.asarray(seq)
    if seq.ndim == 1:
        seq = seq[None]
    table = _table(ix_to_word)
    keep = np.logical_and.accumulate(seq > 0, axis=-1)
    out = []
    for row, k in zip(seq, keep):
        ids = row[k]
        out.append(" ".join(table[ids[ids < table.size]]))
    return out
