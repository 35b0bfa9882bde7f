"""Distributed pieces of the port: the sharding rules, ``constrain`` and
ZeRO-1 specs (``sharding.py``), the collectives the sharded model calls
(``collectives.py``), GPipe stages (``pipeline.py``) and int8 gradient
compression (``compression.py``)."""

from .compression import (compress, compressed_psum, decompress, init_error_state,
                          quantize_with_feedback)
from .sharding import ShardingRules, constrain, default_rules, logical_sharding_tree, zero1_spec

__all__ = ["ShardingRules", "compress", "compressed_psum", "constrain", "decompress",
           "default_rules", "init_error_state", "logical_sharding_tree",
           "quantize_with_feedback", "zero1_spec"]
