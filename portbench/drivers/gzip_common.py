"""What the gzip drivers share: the configuration's file, made from the
seed, and readers opened with the configuration's settings."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from .. import inputs


def make_file(seed: int, cfg: Dict, name: str = "file",
              nbytes: Optional[int] = None) -> Tuple[bytes, bytes]:
    """(text, archive) of the configuration's file (``nbytes`` of text
    instead of its size, if given), from the seed's stream ``name``."""
    size = int(cfg["decompressed_bytes"]) if nbytes is None else int(nbytes)
    text = inputs.base64_text(inputs.stream(seed, name), size, int(cfg["line_columns"]))
    return text, inputs.gzip_member(text, int(cfg["gzip_level"]))


def reader_kwargs(cfg: Dict) -> Dict:
    return {"parallelization": int(cfg["parallelization"]),
            "chunk_size": int(cfg["chunk_size"]),
            "index_spacing": int(cfg["index_spacing"]),
            "verify": bool(cfg["verify_crc"])}


def add_counts(total: Dict[str, int], more: Dict[str, int]) -> None:
    for k, v in more.items():
        total[k] = total.get(k, 0) + int(v)


def delta(after: Dict, before: Dict) -> Dict:
    return {k: after[k] - before.get(k, 0) for k in after}
