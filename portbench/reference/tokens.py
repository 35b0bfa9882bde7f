"""The byte tokenizer and the packing of the corpus pipeline, frozen:
tokens 0-255 are bytes, 256-258 the specials; each shard's stream is BOS
and its bytes (no EOS), the shards follow one another and start again
after the last, and a batch is the next ``batch x (seq_len + 1)`` tokens of
that stream, row after row."""

from __future__ import annotations

from typing import Sequence

import numpy as np

PAD, BOS, EOS = 256, 257, 258


def shard_tokens(text: bytes) -> np.ndarray:
    body = np.frombuffer(text, np.uint8).astype(np.int32)
    return np.concatenate([np.array([BOS], np.int32), body])


def batches(shard_texts: Sequence[bytes], batch: int, seq_len: int, count: int) -> np.ndarray:
    """The first ``count`` batches, ``[count, batch, seq_len + 1]`` int32."""
    need = count * batch * (seq_len + 1)
    parts, have, i = [], 0, 0
    streams = [shard_tokens(t) for t in shard_texts]
    while have < need:
        parts.append(streams[i % len(streams)])
        have += parts[-1].shape[0]
        i += 1
    return np.concatenate(parts)[:need].reshape(count, batch, seq_len + 1)
