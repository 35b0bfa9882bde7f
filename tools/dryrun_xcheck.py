#!/usr/bin/env python3
"""Hold every dry-run cell of ``repro_torch`` against the reference's compiled program.

    PYTHONPATH=src python3 tools/dryrun_xcheck.py [--arch A[,B]] [--shape S] \\
        [--mesh single|multi|both] [--out results/dryrun_xcheck.json] [--force] [--jobs N]

For each ``ok`` cell of ``results/dryrun_torch.json`` it counts rank 0's
train, prefill or decode step in both packages at the two depths of
``_layer_variants`` (the same function in both), on the CPU, and records
per chip, side by side:

  * dot FLOPs: the reference's from its compiled per-partition HLO
    (``hlo_counts``: 2 x the output's elements x the lhs contracting dims'
    sizes, for every ``dot``, not ``cost_analysis()``, which counts
    elementwise work as well); the port's from ``FlopCounterMode`` in
    ``repro_torch.launch.dryrun.run_step``;
  * argument bytes: the reference's ``memory_analysis()`` (and the blocks
    of the arguments jit drops because the program never reads them)
    against the port's rank-0 blocks;
  * collective wire bytes by kind: ``repro.launch.roofline.
    collective_wire_bytes`` of each collective in the HLO against the
    port's records.

The reference side lowers the step with its own functions
(``make_train_step``, the prefill ``jax.jit`` of ``repro.launch.dryrun``,
``make_serve_steps``) on 256 or 512 host devices, with one change: a train
cell's batch carries ``batch_shardings`` (its ``jit_step`` declares the batch
``None``, so the reference's own dry-run lowers it replicated). Its scans are
unrolled (``scan_unroll=True``) except in the train and prefill cells of
the hybrid and the xLSTM (``unrolled``), where each loop body counts its
``known_trip_count`` times; a module with a dot in a loop of no known trip
count, or with a convolution, is ``unsupported``. Each side of a cell runs
in a process of its own (JAX fixes its host device count at its first
import; the port's fake group is one a process); a side past ``--timeout``
seconds is ``timeout``. The results file is keyed as
``results/dryrun_torch.json`` and written after every cell, so a run
resumes where it stopped; each figure outside its bound (dot FLOPs within
``FLOPS_TOL``, wire within ``WIRE_FACTOR``, argument bytes equal) carries its
cause from ``CAUSES``, applied again on every run.
"""

from __future__ import annotations

import argparse
import fnmatch
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
DRYRUN = ROOT / "results" / "dryrun_torch.json"
OUT = ROOT / "results" / "dryrun_xcheck.json"
#: Port/reference dot FLOPs within this, and argument bytes equal, or the
#: gap needs its cause.
FLOPS_TOL = 0.02
#: Collective totals further apart than this factor need a cause.
WIRE_FACTOR = 2.0
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")


# ---------------------------------------------------------------------------
# the compiled HLO's dots
# ---------------------------------------------------------------------------

class HloCountError(ValueError):
    """The module holds what the dot count cannot count faithfully."""


_COMP_RE = re.compile(r"^(ENTRY\s+)?%([\w.\-]+)\s*\(.*\{\s*$")
_INSTR_RE = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*(.*)$")
_SHAPE_RE = re.compile(r"([a-z]+[0-9]*)\[([0-9,]*)\]")
_CALLEE_RE = re.compile(r"\b(calls|to_apply|body|condition|true_computation|"
                        r"false_computation)=%([\w.\-]+)")
_BRANCHES_RE = re.compile(r"branch_computations=\{([^}]*)\}")
_TRIP_RE = re.compile(r'"known_trip_count"\s*:\s*\{\s*"n"\s*:\s*"(\d+)"')
_OP_NAME_RE = re.compile(r'op_name="([^"]*)"')


def _split_type(rest: str) -> Tuple[str, str]:
    """``rest`` after ``=``: (its type, what follows it)."""
    if rest.startswith("("):
        depth = 0
        for i, ch in enumerate(rest):
            depth += ch == "("
            depth -= ch == ")"
            if depth == 0:
                return rest[: i + 1], rest[i + 1 :].lstrip()
    i = rest.find(" ")
    return rest[:i], rest[i + 1 :]


def _dims(type_str: str) -> List[int]:
    m = _SHAPE_RE.match(type_str)
    if m is None:
        raise HloCountError("not an array type: %r" % type_str)
    return [int(x) for x in m.group(2).split(",") if x]


def _call(rest: str) -> Tuple[str, List[str], str]:
    """(opcode, operand names, attributes) of an instruction's text after
    its type."""
    i = rest.index("(")
    opcode, depth = rest[:i], 0
    for j in range(i, len(rest)):
        depth += rest[j] in "({"
        depth -= rest[j] in ")}"
        if depth == 0:
            break
    inner, attrs = rest[i + 1 : j], rest[j + 1 :]
    names, depth, cur = [], 0, ""
    for ch in inner + ",":
        if ch == "," and depth == 0:
            tok = cur.strip().split()
            names.append(tok[-1].lstrip("%") if tok else "")
            cur = ""
            continue
        depth += ch in "([{"
        depth -= ch in ")]}"
        cur += ch
    return opcode, names, attrs


def _int_list(attrs: str, key: str) -> List[int]:
    m = re.search(key + r"=\{([0-9,]*)\}", attrs)
    return [int(x) for x in m.group(1).split(",") if x] if m else []


def parse_hlo(text: str) -> Dict[str, Dict[str, Any]]:
    """{computation: {"entry", "shapes" (name -> type), "instrs" [(name,
    type, opcode, operands, attrs, line)]}} of an HLO module's text."""
    comps: Dict[str, Dict[str, Any]] = {}
    cur = None
    for line in text.splitlines():
        if cur is None:
            m = _COMP_RE.match(line)
            if m:
                cur = comps[m.group(2)] = {"entry": bool(m.group(1)), "shapes": {},
                                          "instrs": []}
            continue
        if line.strip() == "}":
            cur = None
            continue
        m = _INSTR_RE.match(line)
        if m is None:
            continue
        name = m.group(1)
        type_str, rest = _split_type(m.group(2))
        opcode, operands, attrs = _call(rest)
        cur["shapes"][name] = type_str
        cur["instrs"].append((name, type_str, opcode, operands, attrs, line))
    return comps


def dot_flops_of(type_str: str, lhs_type: str, attrs: str) -> int:
    """2 x the output's elements x the lhs contracting dims' sizes."""
    lhs = _dims(lhs_type)
    return 2 * math.prod(_dims(type_str)) * math.prod(
        lhs[d] for d in _int_list(attrs, "lhs_contracting_dims"))


def hlo_counts(text: str, *, trip_counts: bool = False) -> Dict[str, Any]:
    """The dots and collectives of one partition of a compiled module:
    {"flops", "by_op" {op_name metadata: dot FLOPs}, "dots" [(op_name, out
    type, lhs type, flops, times)], "collectives" [(HLO line, times)]}. An
    instruction counts once per execution of its computation: once per call
    of a fusion, and once per iteration of a ``while`` body only with
    ``trip_counts`` and the loop's ``known_trip_count``; a ``while`` or
    ``conditional`` whose body holds a dot otherwise raises
    ``HloCountError``, and so does a ``convolution``."""
    comps = parse_hlo(text)
    own: Dict[str, List[Tuple[str, Any, int]]] = {}
    for cname, c in comps.items():
        events = own[cname] = []
        for name, type_str, opcode, operands, attrs, line in c["instrs"]:
            if opcode == "convolution":
                raise HloCountError("convolution %s in %s" % (name, cname))
            if opcode.replace("-start", "") in KINDS:
                events.append(("collective", line, 1))
            if opcode != "dot":
                continue
            lhs = c["shapes"].get(operands[0])
            if lhs is None:
                raise HloCountError("dot %s: operand %s has no shape in %s"
                                    % (name, operands[0], cname))
            m = _OP_NAME_RE.search(attrs)
            events.append(("dot", (m.group(1) if m else name, type_str, lhs,
                                   dot_flops_of(type_str, lhs, attrs)), 1))

    memo: Dict[str, List[Tuple[str, Any, int]]] = {}

    def walk(cname: str, stack: Tuple[str, ...] = ()) -> List[Tuple[str, Any, int]]:
        if cname in memo:
            return memo[cname]
        if cname in stack:
            raise HloCountError("recursive computation %s" % cname)
        out = list(own[cname])
        for name, _, opcode, _, attrs, _ in comps[cname]["instrs"]:
            callees = [m.group(2) for m in _CALLEE_RE.finditer(attrs)]
            b = _BRANCHES_RE.search(attrs)
            if b:
                callees += [s.strip().lstrip("%") for s in b.group(1).split(",") if s.strip()]
            for callee in callees:
                inner = walk(callee, stack + (cname,))
                if not inner:
                    continue
                dot = next((e[1][0] for e in inner if e[0] == "dot"), None)
                times = 1
                if opcode == "while":
                    m = _TRIP_RE.search(attrs)
                    if trip_counts and m:
                        times = int(m.group(1))
                    elif dot is not None:
                        raise HloCountError(
                            "while %s in %s: its body %s holds a dot (%s)%s"
                            % (name, cname, callee, dot, "" if m else ", and no known trip count"))
                elif opcode == "conditional" and dot is not None:
                    raise HloCountError("conditional %s in %s: branch %s holds a dot (%s)"
                                        % (name, cname, callee, dot))
                out += [(kind, what, n * times) for kind, what, n in inner]
        memo[cname] = out
        return out

    entry = [n for n, c in comps.items() if c["entry"]]
    if len(entry) != 1:
        raise HloCountError("%d entry computations" % len(entry))
    events = walk(entry[0])
    dots = [what + (n,) for kind, what, n in events if kind == "dot"]
    by_op: Dict[str, int] = {}
    for op, _, _, f, times in dots:
        by_op[op] = by_op.get(op, 0) + f * times
    return {"flops": sum(f * t for _, _, _, f, t in dots), "by_op": by_op, "dots": dots,
            "collectives": [(what, n) for kind, what, n in events if kind == "collective"]}


def hlo_dot_flops(text: str, *, trip_counts: bool = False) -> int:
    """The dot FLOPs of one partition of a compiled module (``hlo_counts``)."""
    return hlo_counts(text, trip_counts=trip_counts)["flops"]


def hlo_wire_bytes(counts: Dict[str, Any], n_chips: int) -> Dict[str, Any]:
    """``repro.launch.roofline.collective_wire_bytes`` of each collective
    of ``hlo_counts``, times its executions: per kind, ``total`` and
    ``counts``."""
    from repro.launch.roofline import collective_wire_bytes

    out: Dict[str, Any] = {k: 0.0 for k in KINDS}
    n: Dict[str, int] = {k: 0 for k in KINDS}
    for line, times in counts["collectives"]:
        w = collective_wire_bytes(line, default_group=n_chips)
        for k in KINDS:
            out[k] += w[k] * times
            n[k] += w["counts"][k] * times
    out["total"] = sum(out[k] for k in KINDS)
    out["counts"] = n
    return out


# ---------------------------------------------------------------------------
# the reference's cell (a process of its own)
# ---------------------------------------------------------------------------

def unrolled(family: str, kind: str) -> bool:
    """Whether the reference's cell is lowered with ``_layer_variants``'
    ``scan_unroll=True``. Not a train or prefill cell of the hybrid (its
    SSM scans every position) or the xLSTM (its mLSTM every chunk): unrolled,
    their modules hold one loop body per position or chunk and compile for
    hours. Those keep every scan a loop, and each loop's instructions count
    its known trip count times (``hlo_counts(trip_counts=True)``)."""
    return not (family in ("hybrid", "ssm") and kind != "decode")


def reference_variant(arch: str, shape_name: str, multi_pod: bool, variant: int) -> Dict[str, Any]:
    """Compile the reference's step of a cell at ``_layer_variants``'
    depth ``variant`` (0 or 1) and count it. Call in a fresh process."""
    import dataclasses

    from repro.launch import dryrun as ref  # sets XLA_FLAGS before JAX starts

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.configs.base import SHAPES, get_config, input_specs
    from repro.distributed.sharding import batch_partition, default_rules
    from repro.launch.mesh import make_production_mesh
    from repro.models.model import build_model
    from repro.models.transformer import ModelContext
    from repro.serve.serve_step import make_serve_steps
    from repro.train.optimizer import AdamWConfig, init_opt_state
    from repro.train.train_step import (batch_shardings, make_train_step,
                                        opt_state_shardings, param_shardings)

    cfg = ref._layer_variants(get_config(arch))[variant]
    shape = SHAPES[shape_name]
    unroll = unrolled(cfg.family, shape.kind)
    cfg = dataclasses.replace(cfg, scan_unroll=unroll)
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_chips = 512 if multi_pod else 256
    rules = default_rules(mesh)
    model = build_model(cfg)
    params_abs = model.abstract()
    specs = input_specs(cfg, shape)
    t0 = time.perf_counter()
    if shape.kind == "train":
        fn, _ = make_train_step(model, mesh, rules, AdamWConfig(total_steps=1000))
        opt_abs = jax.eval_shape(init_opt_state, params_abs)
        # the train step declares the batch None: give it its sharding here
        shard = batch_shardings(mesh, rules, specs)
        batch = {k: jax.ShapeDtypeStruct(v.shape, v.dtype, sharding=shard[k])
                 for k, v in specs.items()}
        args = (params_abs, opt_abs, batch)
        declared = (param_shardings(model, mesh, rules),
                    opt_state_shardings(model, mesh, rules), shard)
    elif shape.kind == "prefill":  # as repro.launch.dryrun.lower_cell jits it
        ctx = ModelContext(mesh, rules)
        p_shard = param_shardings(model, mesh, rules)
        b_shard = {k: NamedSharding(mesh, P(*(list(batch_partition(mesh, v.shape[0]))
                                              + [None] * (len(v.shape) - 1))))
                   for k, v in specs.items()}
        fn = jax.jit(lambda p, b: model.prefill(p, b, ctx), in_shardings=(p_shard, b_shard))
        args, declared = (params_abs, specs), (p_shard, b_shard)
    else:
        _, jit_decode, caches_abs, sh = make_serve_steps(
            model, mesh, rules, batch=shape.global_batch, max_len=shape.seq_len)
        fn = jit_decode
        args = (params_abs, specs["tokens"], caches_abs, jax.ShapeDtypeStruct((), jnp.int32))
        declared = (sh["params"], sh["tokens"], sh["caches"], NamedSharding(mesh, P()))
    compiled = fn.lower(*args).compile()
    seconds = time.perf_counter() - t0
    # jit drops the arguments the program never reads (decode's encoder and
    # cross K/V weights, a recurrent decode's position): their blocks are
    # not among the compiled program's arguments
    pruned = []
    jax.tree_util.tree_map(
        lambda a, sh, kept: pruned.append(math.prod(sh.shard_shape(a.shape)) * a.dtype.itemsize)
        if kept is None else None,
        args, declared, tuple(compiled.input_shardings[0]), is_leaf=lambda x: x is None)
    hlo = compiled.as_text()
    counts = hlo_counts(hlo, trip_counts=not unroll)
    wire = hlo_wire_bytes(counts, n_chips)
    return {
        "n_layers": cfg.n_layers,
        "scan_unroll": unroll,
        "dot_flops": float(counts["flops"]),
        "by_op": counts["by_op"],
        "loops": sum(1 for line in hlo.splitlines() if " while(" in line),
        "argument_size_in_bytes": int(compiled.memory_analysis().argument_size_in_bytes),
        "pruned_argument_bytes": int(sum(pruned)),
        "wire": {k: float(v) for k, v in wire.items() if k != "counts"},
        "wire_counts": wire["counts"],
        "compile_s": seconds,
    }


# ---------------------------------------------------------------------------
# the port's cell (a process of its own: one fake group)
# ---------------------------------------------------------------------------

def port_variant(arch: str, shape_name: str, multi_pod: bool, variant: int) -> Dict[str, Any]:
    """Run the port's step of a cell at ``_layer_variants``' depth
    ``variant`` over a fake group and count it (``run_step``)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.roofline import collective_wire_bytes

    cfg = dryrun._layer_variants(get_config(arch))[variant]
    mesh = dryrun.production_mesh(multi_pod, "cpu")
    t0 = time.perf_counter()
    m = dryrun.run_step(cfg, SHAPES[shape_name], mesh, device="cpu")
    wire = collective_wire_bytes(m["collectives"])
    counts = wire.pop("counts")
    return {
        "n_layers": cfg.n_layers,
        "dot_flops": m["flops"],
        "argument_size_in_bytes": m["argument_size_in_bytes"],
        "wire": {k: float(v) for k, v in wire.items()},
        "wire_counts": counts,
        "run_s": time.perf_counter() - t0,
    }


def _worker(side: str, key: str, variants: List[int], out: str) -> None:
    """Count one side of the cell ``key`` (``arch|shape|mesh``) at the
    ``_layer_variants`` depths ``variants``, writing ``out`` (JSON); an
    error is recorded, not raised."""
    arch, shape_name, mesh = key.split("|")
    fn = reference_variant if side == "reference" else port_variant
    t0 = time.perf_counter()
    try:
        r: Dict[str, Any] = {"variants": [fn(arch, shape_name, mesh == "multi", v)
                                          for v in variants]}
    except HloCountError as exc:
        r = {"unsupported": str(exc)}
    except Exception as exc:  # noqa: BLE001 - recorded in the cell
        r = {"error": "%s: %s" % (type(exc).__name__, exc)}
    r["wall_s"] = time.perf_counter() - t0
    with open(out, "w") as f:
        json.dump(r, f)


def count_side(side: str, key: str, *, timeout: float = 1800.0,
               variants: Tuple[int, ...] = (0, 1)) -> Dict[str, Any]:
    """One side of a cell, counted in a fresh process (``_worker``): its
    variants, or ``{"timeout": ...}`` past ``timeout`` seconds."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(SRC), os.environ.get("PYTHONPATH")) if p), JAX_PLATFORMS="cpu")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="xcheck") as tmp:
        out = os.path.join(tmp, side + ".json")
        cmd = [sys.executable, os.path.abspath(__file__), "--worker", side, "--cells", key,
               "--variants", ",".join(map(str, variants)), "--out", out]
        try:
            subprocess.run(cmd, env=env, timeout=timeout, check=False)
        except subprocess.TimeoutExpired:
            pass
        if os.path.exists(out):
            with open(out) as f:
                return json.load(f)
    return {"timeout": "no result within %.0f s" % timeout, "wall_s": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# one cell, side by side
# ---------------------------------------------------------------------------

#: Why a figure of a cell lies outside its bound where the port is not at
#: fault, by (``fnmatch`` pattern of ``arch|shape|mesh``, figure); the first
#: pattern that matches holds. ``ROADMAP.md`` (queue 3) has the detail
#: behind each, and PERF.md section 6 the counts.
CAUSES: List[Tuple[Tuple[str, str], str]] = [
    (("xlstm-350m|long_500k|*", "wire"),
     "the reference spreads the one-row products (batch 1, alike on every rank) over data and "
     "model and gathers their outputs; the port runs them whole on every rank"),
    (("*|train_4k|*", "wire"),
     "the reference's CPU-compiled program sums in f32 (XLA's CPU backend runs bf16 products "
     "in f32), all-reduces more partial products (an MLP's two input gradients apart, K/V's "
     "where it splits the KV heads) and all-reduces the gradients over data, which the port "
     "reduce-scatters (ZeRO-1)"),
    (("*|decode_32k|*", "wire"),
     "the port's decode returns the global logits on every rank, gathered over the DP axes "
     "(and over model where the vocabulary splits; serve_step.gathered_logits); the "
     "reference's leaves them sharded (out_shardings None)"),
    (("*|long_500k|*", "wire"),
     "the port's decode returns the global logits on every rank, gathered over model where "
     "the vocabulary splits; the reference's leaves them sharded"),
    (("xlstm-350m|train_4k|*", "dot_flops"),
     "the reference computes w_qkv's whole weight gradient on every rank (f32[6144,2048], "
     "1.649e12 a block); the port its 128-row block; the port still runs a head's mLSTM "
     "scores over its whole Dk on 4 ranks and the sLSTM's products whole (queue 3)"),
    (("xlstm-350m|prefill_32k|*", "dot_flops"),
     "the port runs a head's mLSTM scores over its whole Dk on 4 ranks and the sLSTM's "
     "products whole on every rank; the reference splits both 16 ways (queue 3)"),
    (("xlstm-350m|decode_32k|*", "dot_flops"),
     "the reference splits the sLSTM's recurrent product and w_out over model (8 rows a "
     "rank) and gathers them; the port runs them whole"),
    (("xlstm-350m|long_500k|*", "dot_flops"),
     "the reference spreads the one-row products (batch 1, alike on every rank) over data and "
     "model; the port runs them whole on every rank"),
]


def annotate(cell: Dict[str, Any]) -> Dict[str, Any]:
    """Each figure of an ``ok`` cell outside its bound, with its cause:
    ``CAUSES``' line, or for argument bytes that the compiled program's
    dropped arguments account for, that; ``uncaused`` lists the rest."""
    if cell.get("status") != "ok":
        return cell
    key = "%s|%s|%s" % (cell["arch"], cell["shape"],
                        "multi" if cell["mesh"] == "2x16x16" else "single")
    out = {}
    for figure, ok in (("dot_flops", cell["flops_within"]),
                       ("argument_bytes", cell["argument_bytes_equal"]),
                       ("wire", cell["wire_within"])):
        if ok:
            continue
        if figure == "argument_bytes" and all(cell["argument_bytes_equal_with_pruned"]):
            out[figure] = ("the compiled program drops %s bytes of arguments it never reads "
                           "(jit prunes them); the port's step holds them"
                           % "/".join(map(str, cell["reference"]["pruned_argument_bytes"])))
            continue
        out[figure] = next((why for (pattern, fig), why in CAUSES
                            if fig == figure and fnmatch.fnmatchcase(key, pattern)), None)
    cell["causes"] = {k: v for k, v in out.items() if v}
    cell["uncaused"] = sorted(k for k, v in out.items() if not v)
    return cell


def _ratio(a: float, b: float) -> Optional[float]:
    return a / b if b else (1.0 if a == b else None)


def _full_depth(v: List[Dict[str, Any]], n_layers: int, key: str) -> float:
    (l1, a), (l2, b) = ((x["n_layers"], x[key]) for x in v)
    return b + (b - a) / (l2 - l1) * (n_layers - l2)


def side_by_side(key: str, ref: Dict[str, Any], port: Dict[str, Any],
                 dryrun_cell: Dict[str, Any], n_layers: int) -> Dict[str, Any]:
    """The record of one cell from both sides' variants."""
    arch, shape, mesh = key.split("|")
    cell: Dict[str, Any] = {"arch": arch, "shape": shape, "mesh": dryrun_cell["mesh"],
                            "kind": dryrun_cell["kind"],
                            "wall_s": {"reference": round(ref.get("wall_s", 0.0), 2),
                                       "port": round(port.get("wall_s", 0.0), 2)}}
    for side, r in (("reference", ref), ("port", port)):
        if "timeout" in r:
            cell.update(status="timeout", reason="%s side: %s" % (side, r["timeout"]))
            return cell
        if "unsupported" in r or "error" in r:
            cell.update(status="unsupported",
                        reason="%s side: %s" % (side, r.get("unsupported") or r["error"]))
            return cell
    rv, pv = ref["variants"], port["variants"]
    cell["n_layers"] = [v["n_layers"] for v in rv]
    for side, vs in (("reference", rv), ("port", pv)):
        cell[side] = {
            "dot_flops": [v["dot_flops"] for v in vs],
            "argument_size_in_bytes": [v["argument_size_in_bytes"] for v in vs],
            "wire": [v["wire"] for v in vs],
            "wire_counts": [v["wire_counts"] for v in vs],
        }
    cell["reference"]["pruned_argument_bytes"] = [v["pruned_argument_bytes"] for v in rv]
    cell["reference"]["loops"] = [v["loops"] for v in rv]
    cell["reference"]["scan_unroll"] = rv[0]["scan_unroll"]
    cell["reference"]["top_dots"] = [
        sorted(v["by_op"].items(), key=lambda kv: -kv[1])[:8] for v in rv]
    ratio = {
        "dot_flops": [_ratio(p, r) for p, r in zip(cell["port"]["dot_flops"],
                                                   cell["reference"]["dot_flops"])],
        "argument_size_in_bytes": [_ratio(p, r) for p, r in zip(
            cell["port"]["argument_size_in_bytes"], cell["reference"]["argument_size_in_bytes"])],
        "wire_total": [_ratio(p["total"], r["total"]) for p, r in zip(
            cell["port"]["wire"], cell["reference"]["wire"])],
    }
    cell["ratio"] = ratio
    cell["full_depth"] = {
        "n_layers": n_layers,
        "reference_dot_flops": _full_depth(rv, n_layers, "dot_flops"),
        "port_dot_flops": _full_depth(pv, n_layers, "dot_flops"),
        "port_dryrun_flops": dryrun_cell["cost"]["flops"],
    }
    flops_ok = all(r is not None and abs(r - 1.0) <= FLOPS_TOL for r in ratio["dot_flops"])
    port_b = cell["port"]["argument_size_in_bytes"]
    ref_b = cell["reference"]["argument_size_in_bytes"]
    bytes_ok = port_b == ref_b
    wire_ok = all(r is not None and 1 / WIRE_FACTOR <= r <= WIRE_FACTOR
                  for r in ratio["wire_total"])
    cell.update(status="ok", flops_within=flops_ok, argument_bytes_equal=bytes_ok,
                argument_bytes_equal_with_pruned=[
                    p == r + d for p, r, d in zip(port_b, ref_b,
                                                  cell["reference"]["pruned_argument_bytes"])],
                wire_within=wire_ok)
    return annotate(cell)


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

def _cells(args) -> List[str]:
    with open(DRYRUN) as f:
        dry = json.load(f)
    archs = None if args.arch == "all" else set(args.arch.split(","))
    shapes = None if args.shape == "all" else set(args.shape.split(","))
    meshes = {"single": {"single"}, "multi": {"multi"}, "both": {"single", "multi"}}[args.mesh]
    return [k for k, c in dry.items() if c["status"] == "ok"
            and (archs is None or c["arch"] in archs)
            and (shapes is None or c["shape"] in shapes) and k.split("|")[2] in meshes]


def xcheck_cell(key: str, dryrun_cell: Dict[str, Any], timeout: float) -> Dict[str, Any]:
    """Both sides of one cell, each in a process of its own."""
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config

    sides = {side: count_side(side, key, timeout=timeout) for side in ("reference", "port")}
    return side_by_side(key, sides["reference"], sides["port"], dryrun_cell,
                        get_config(key.split("|")[0]).n_layers)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--force", action="store_true", help="count cells already in --out again")
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="seconds a side of one cell may take (both depths)")
    ap.add_argument("--jobs", type=int, default=1, help="cells counted at once")
    ap.add_argument("--worker", choices=["reference", "port"], help=argparse.SUPPRESS)
    ap.add_argument("--cells", help=argparse.SUPPRESS)
    ap.add_argument("--variants", default="0,1", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.worker:
        sys.path.insert(0, str(SRC))
        _worker(args.worker, args.cells, [int(v) for v in args.variants.split(",")], args.out)
        return

    from concurrent.futures import ThreadPoolExecutor

    with open(DRYRUN) as f:
        dry = json.load(f)
    results: Dict[str, Any] = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    todo = [k for k in _cells(args)
            if args.force or results.get(k, {}).get("status") not in ("ok", "unsupported")]

    lock = threading.Lock()

    def write() -> None:
        with open(args.out, "w") as f:
            json.dump(dict(sorted(results.items(), key=lambda kv: list(dry).index(kv[0]))),
                      f, indent=1)

    def one(key: str) -> None:
        print("[xcheck] %s: counting..." % key, flush=True)
        cell = xcheck_cell(key, dry[key], args.timeout)
        with lock:
            results[key] = cell
            write()
        print("[xcheck] %s: %s" % (key, summary(cell)), flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with ThreadPoolExecutor(max(1, args.jobs)) as pool:
        list(pool.map(one, todo))
    with open(DRYRUN) as f:  # as the dry-run's file and this file's causes stand now
        dry = json.load(f)
    for key, cell in results.items():
        if cell.get("status") == "ok":
            cell["full_depth"]["port_dryrun_flops"] = dry[key]["cost"]["flops"]
        annotate(cell)
    write()
    cells = [results[k] for k in _cells(args) if k in results]
    n = {s: sum(c["status"] == s for c in cells) for s in ("ok", "unsupported", "timeout")}
    outside = [c for c in cells if c["status"] == "ok" and (c["causes"] or c["uncaused"])]
    print("[xcheck] done: %(ok)d ok, %(unsupported)d unsupported, %(timeout)d timeout" % n,
          "- %d with a figure outside its bound, %d of them without a cause"
          % (len(outside), sum(bool(c["uncaused"]) for c in outside)))


def summary(cell: Dict[str, Any]) -> str:
    if cell["status"] != "ok":
        return "%s (%s)" % (cell["status"], cell["reason"])
    r = cell["ratio"]
    return ("dot FLOPs port/ref %s, argument bytes %s, wire total port/ref %s (%.0f s + %.0f s)"
            % ("/".join("%.4f" % x for x in r["dot_flops"]),
               "equal" if cell["argument_bytes_equal"] else "differ " + "/".join(
                   "%.6f" % x for x in r["argument_size_in_bytes"]),
               "/".join("%.3f" % x if x is not None else "-" for x in r["wire_total"]),
               cell["wall_s"]["reference"], cell["wall_s"]["port"]))


if __name__ == "__main__":
    main()
