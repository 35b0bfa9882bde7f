"""Byte-level tokenizer with reserved specials and vocab folding.

Training the assigned architectures needs nothing fancier than a robust
byte-level scheme: tokens 0..255 are raw bytes; specials follow. Vocab
sizes above 256+specials are simply sparse (real BPE slots unused) — the
embedding math is identical, which is what the substrate needs.
"""

from __future__ import annotations

from typing import Iterable, List

import numpy as np

PAD = 256
BOS = 257
EOS = 258
N_SPECIALS = 3


class ByteTokenizer:
    def __init__(self, vocab_size: int = 512):
        if vocab_size < 256 + N_SPECIALS:
            raise ValueError("vocab_size must be >= 259")
        self.vocab_size = vocab_size

    def encode(self, data: bytes, *, add_bos: bool = True, add_eos: bool = True) -> np.ndarray:
        parts: List[np.ndarray] = []
        if add_bos:
            parts.append(np.array([BOS], np.int32))
        parts.append(np.frombuffer(data, np.uint8).astype(np.int32))
        if add_eos:
            parts.append(np.array([EOS], np.int32))
        return np.concatenate(parts)

    def decode(self, tokens: Iterable[int]) -> bytes:
        return bytes(int(t) for t in tokens if 0 <= int(t) < 256)
