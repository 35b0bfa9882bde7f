"""Distributed pieces of the port. On one card only gradient compression
(``compression.py``) runs; the sharding rules, ``constrain``, ZeRO-1 and the
pipeline stages of the JAX package's ``distributed`` need a mesh and wait
for the distributed slice (ROADMAP.md, queue 1)."""

from .compression import compress, decompress, init_error_state, quantize_with_feedback

__all__ = ["compress", "decompress", "init_error_state", "quantize_with_feedback"]
