"""Roofline terms of one step on one NVIDIA H100, from the dry-run's counts.

    compute    = FLOPs_per_chip / 989e12       (bf16 dense peak, H100 SXM)
    memory     = bytes_per_chip / 3.35e12      (HBM3 bandwidth)
    collective = wire_bytes_per_chip / 50e9    (one 400 Gb/s InfiniBand port)

The counterpart of ``repro.launch.roofline``. The port has no compiled
program to read: ``launch.dryrun`` runs rank 0's real step and records its
FLOPs, its bytes and every collective it issues (kind, bytes, group size),
so the terms are per chip by construction. Each collective's wire bytes
take the ring-algorithm factor for its group size n, as the JAX package
counts them:

    all-reduce      2 * (n-1)/n * size
    all-gather      (n-1)/n * size          (size = gathered output)
    reduce-scatter  (n-1) * size            (size = scattered output)
    all-to-all      (n-1)/n * size
    collective-permute  size
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Optional

# NVIDIA H100 SXM data sheet (dense rates, no sparsity, at the 700 W limit).
PEAK_FLOPS = 989e12  # bf16 / chip
HBM_BW = 3.35e12  # bytes/s, HBM3
HBM_BYTES = 80e9  # device memory, bytes
# One 400 Gb/s NDR InfiniBand port per GPU, as in NVIDIA's DGX H100 system
# (eight ConnectX-7 ports a host). Each axis of 16 of the production mesh
# spans two 8-GPU hosts, so its ring runs at this rate: the conservative
# one, the role one ICI link's 50e9 plays in the JAX package.
COLLECTIVE_BW = 50e9  # bytes/s
# NVLink 4 within one host (H100 SXM data sheet: 900 GB/s in both directions),
# for a group that fits inside one 8-GPU host.
NVLINK_BW = 450e9  # bytes/s each way

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")


def wire_factor(kind: str, n: int) -> float:
    """Ring-algorithm wire bytes per byte of ``size`` for a group of ``n``."""
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n
    if kind in ("all-gather", "all-to-all"):
        return (n - 1) / n
    if kind == "reduce-scatter":
        return float(n - 1)
    if kind == "collective-permute":
        return 1.0
    raise ValueError("unknown collective kind %r" % kind)


def collective_wire_bytes(collectives: Iterable[Mapping]) -> Dict[str, float]:
    """Per-chip wire bytes by collective kind (ring-algorithm accounting).

    ``collectives``: the records of one step, each with ``kind`` (one of
    ``KINDS``), ``bytes`` (the size the factor applies to: the gathered
    output of an all-gather, the scattered output of a reduce-scatter, the
    buffer of the others) and ``group`` (its group size). A group of one
    moves nothing and is not counted."""
    out: Dict[str, float] = {k: 0.0 for k in KINDS}
    counts: Dict[str, int] = {k: 0 for k in KINDS}
    for c in collectives:
        n = int(c["group"])
        if n <= 1:
            continue
        out[c["kind"]] += wire_factor(c["kind"], n) * float(c["bytes"])
        counts[c["kind"]] += 1
    out["total"] = sum(out.values())
    out["counts"] = counts  # type: ignore[assignment]
    return out


def roofline_terms(
    cost: Dict[str, float],
    wire: Dict[str, float],
    *,
    while_trip_counts: Optional[List[int]] = None,
) -> Dict[str, float]:
    """Three roofline terms in seconds (per chip, per step)."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    coll = float(wire.get("total", 0.0))
    terms = {
        "flops": flops,
        "bytes": byts,
        "collective_bytes": coll,
        "t_compute": flops / PEAK_FLOPS,
        "t_memory": byts / HBM_BW,
        "t_collective": coll / COLLECTIVE_BW,
    }
    dominant = max(("t_compute", "t_memory", "t_collective"), key=lambda k: terms[k])
    terms["dominant"] = dominant  # type: ignore[assignment]
    bound = max(terms["t_compute"], terms["t_memory"], terms["t_collective"])
    terms["roofline_fraction"] = terms["t_compute"] / bound if bound > 0 else 0.0
    return terms


def model_flops(cfg, shape, n_layers_active: Optional[int] = None) -> float:
    """6 * N(_active) * D for the step's token count (train) or token (decode)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        mult = 6.0
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        mult = 2.0
    else:
        tokens = shape.global_batch  # one new token per sequence
        mult = 2.0
    return mult * n_active * tokens
