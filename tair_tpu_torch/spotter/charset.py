"""Text-recognition character set (printable ASCII) and host-side codecs.

The port's own copy of ``tair_tpu/spotter/charset.py``: 95 printable ASCII
chars (indices 0..94), padding/EOS id 96, max word length 25.
"""

from __future__ import annotations

from typing import Iterable, List

import numpy as np

CTLABELS: List[str] = [chr(i) for i in range(32, 127)]  # ' '..'~', 95 chars
VOC_SIZE = 96          # classifier classes 0..96 (voc_size + 1 logits)
PAD_ID = 96
MAX_WORD_LEN = 25


def encode_text(word: str, max_len: int = MAX_WORD_LEN) -> np.ndarray:
    """word -> int32[max_len], padded with PAD_ID. Raises on non-ASCII."""
    ids = np.full((max_len,), PAD_ID, np.int32)
    for i, ch in enumerate(word[:max_len]):
        ids[i] = CTLABELS.index(ch)
    return ids


def decode_text(idxs: Iterable[int]) -> str:
    """int ids -> string, stopping at the first non-charset id."""
    s = ""
    for idx in idxs:
        idx = int(idx)
        if idx < len(CTLABELS):
            s += CTLABELS[idx]
        else:
            break
    return s


def is_encodable(word: str, max_len: int = MAX_WORD_LEN) -> bool:
    return len(word) < max_len + 1 and all(ch in CTLABELS for ch in word)
