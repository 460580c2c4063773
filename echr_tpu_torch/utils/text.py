"""Token-sequence rendering (echr_tpu/utils/text.py; reference:
misc/utils.py:24-38), the port's copy.  ``decode_sequence`` runs the C++
joiner of echr_tpu_torch/native wherever it is available, as echr_tpu runs
its own (echr_tpu/utils/text.py:53-58): the call releases the GIL, so
caption assembly overlaps the threads that feed the device.
``decode_sequence_numpy`` is its numpy version, string for string equal
(tests/test_torch_native.py)."""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from echr_tpu_torch import native

# vocab dict -> (the dict, id-to-word object array, the words' UTF-8 bytes
# packed end to end, their [V + 1] int32 offsets), keyed by identity; a few
# vocabs at most
_TABLE_CACHE: Dict[int, Tuple[Dict[str, str], np.ndarray, bytes, np.ndarray]] = {}
_TABLE_CACHE_MAX = 8


def _tables(ix_to_word: Dict[str, str]) -> Tuple[Dict[str, str], np.ndarray, bytes, np.ndarray]:
    key = id(ix_to_word)
    hit = _TABLE_CACHE.get(key)
    if hit is not None and hit[0] is ix_to_word:  # id() may be reused after eviction
        return hit
    size = max((int(k) for k in ix_to_word), default=0) + 1
    table = np.empty(size, dtype=object)
    table[:] = ""
    for k, w in ix_to_word.items():
        table[int(k)] = w
    words = [w.encode("utf-8") for w in table]
    offsets = np.zeros(size + 1, np.int32)
    np.cumsum([len(w) for w in words], out=offsets[1:])
    entry = (ix_to_word, table, b"".join(words), offsets)
    while len(_TABLE_CACHE) >= _TABLE_CACHE_MAX:
        _TABLE_CACHE.pop(next(iter(_TABLE_CACHE)))
    _TABLE_CACHE[key] = entry
    return entry


def decode_sequence(ix_to_word: Dict[str, str], seq: np.ndarray) -> List[str]:
    """Token ids [n, L] (or [L]) -> sentences.  A row stops at its first
    id <= 0 (0 is END); ids past the vocab render as nothing.  The C++
    joiner where native.active(), else decode_sequence_numpy."""
    seq = np.asarray(seq)
    if seq.ndim == 1:
        seq = seq[None]
    if native.active():
        _, _, packed, offsets = _tables(ix_to_word)
        return native.render_captions(packed, offsets, seq)
    return decode_sequence_numpy(ix_to_word, seq)


def decode_sequence_numpy(ix_to_word: Dict[str, str], seq: np.ndarray) -> List[str]:
    """decode_sequence by numpy, row by row."""
    seq = np.asarray(seq)
    if seq.ndim == 1:
        seq = seq[None]
    table = _tables(ix_to_word)[1]
    keep = np.logical_and.accumulate(seq > 0, axis=-1)
    out = []
    for row, k in zip(seq, keep):
        ids = row[k]
        out.append(" ".join(table[ids[ids < table.size]]))
    return out
