"""Coerce arbitrary snapshot trees into strictly-JSON-serializable form.

`metrics()`/`snapshot()`/`stats()` dicts are *supposed* to be plain JSON,
but drift happens: a numpy scalar from the device engine, a float nan from
a rate with zero denominator, a tuple key, an exception stashed in a job
record. `sanitize_snapshot` is the gateway-boundary guard: whatever leaks
in, what goes over the wire round-trips through ``json.dumps``/``loads``
without a custom encoder.
"""

from __future__ import annotations

import math
from typing import Any

_SCALARS = (str, int, bool)


def sanitize_snapshot(obj: Any) -> Any:
    """Deep-copy ``obj`` into dict/list/str/int/float/bool/None only.

    Rules: mapping keys become strings; tuples/sets/frozensets become
    lists; non-finite floats become None (json.dumps would emit invalid
    ``NaN``/``Infinity`` tokens); numpy-style scalars are unwrapped via
    ``.item()``; anything else falls back to ``repr``.
    """
    if obj is None or isinstance(obj, _SCALARS):
        return obj
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {str(k): sanitize_snapshot(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [sanitize_snapshot(v) for v in obj]
    if isinstance(obj, (bytes, bytearray)):
        return obj.decode("utf-8", "replace")
    # numpy scalars (and 0-d arrays) unwrap to python scalars via .item().
    item = getattr(obj, "item", None)
    if callable(item):
        try:
            return sanitize_snapshot(item())
        except Exception:  # noqa: BLE001 - fall through to repr
            pass
    return repr(obj)
