"""Multi-pod dry-run: run rank 0's step of every (arch x shape x mesh) cell
on fake tensors over a fake process group, and count its work.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all \\
        --mesh both --device cpu --out results/dryrun_torch.json

The counterpart of ``repro.launch.dryrun``. PyTorch has no lowering, so a
cell does not compile the step: it starts a fake process group of 256
ranks ((data=16, model=16)) or 512 ((pod=2, data=16, model=16)), builds
the port's ``make_production_mesh`` over it and runs rank 0's *real* step
once under ``FakeTensorMode``, where every tensor has its shape, dtype and
device but no data and every collective returns at once:

  * train: one call of ``make_train_step(model, mesh, rules,
    AdamWConfig(total_steps=1000))`` (AdamW, ZeRO-1, the config's remat);
  * prefill: ``model.prefill`` on rank 0's rows, as the JAX dry-run jits
    it, the caches left sharded;
  * decode: the decode function of ``make_serve_steps(model, mesh, rules,
    ...)`` at the last position, on caches of rank 0's blocks
    (``cache_shardings``).

What a cell counts, per chip and per step:
  * FLOPs, by ``torch.utils.flop_counter.FlopCounterMode`` (the matrix
    products and attention; eager runs every layer, so the count needs no
    calibration);
  * bytes: each operation's inputs and outputs, once per operation
    ("unfused eager bytes", what the eager step moves; not XLA's
    post-fusion figure);
  * collectives by kind, with bytes and group size, as rank 0 issues them
    (``roofline.collective_wire_bytes`` takes the ring factors);
  * memory: the arguments (rank 0's parameter, optimizer and batch
    blocks, or its parameters and caches and decode's position), the live
    bytes at the peak of the step (every storage an operation makes, held until it is freed,
    rounded up to the CUDA allocator's 512 bytes), the peak less the
    arguments, and whether the peak fits one H100 (``fits_h100``).

The figures are counts of the port's own eager step and bounds from the
H100 data sheet's peaks; none is a measurement on a card. A cell the port
cannot run (a ``NotImplementedError``) is recorded as ``unsupported`` with
the error's text, not as an error. Nothing starts at import; a
process holds one fake group, whose world size is fixed when it starts, so
``--mesh both`` runs each mesh in a process of its own. ``--device``
places the fake tensors (``cuda``, the default, needs a card; ``cpu`` on
request); no operation runs on either.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..configs.base import (SHAPES, ShapeConfig, all_configs, get_config, input_specs,
                            shape_applicable)
from .roofline import HBM_BYTES, collective_wire_bytes, model_flops, roofline_terms

#: What the cost and roofline figures of a cell are.
BASIS = ("counts of rank 0's eager step on fake tensors (FLOPs: FlopCounterMode; bytes: "
         "unfused eager bytes, each operation's inputs and outputs once) over the H100 SXM data "
         "sheet's peaks; not measurements")
ALLOCATION = 512  # the CUDA caching allocator's rounding


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------

def _tensors(tree) -> List[torch.Tensor]:
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _key(t: torch.Tensor):
    """A key of ``t``'s storage, the same for every view of it."""
    from torch.multiprocessing.reductions import StorageWeakRef

    return StorageWeakRef(t.untyped_storage())


def _collective_ops():
    """{op: (kind, index of its group argument, whether the buffer counted
    is the result)} for the collectives the port's steps issue
    (``distributed.collectives``); otherwise args[0] counts, the output
    buffers of a gather or scatter, the input of a reduction or a send."""
    from ..distributed import collectives  # noqa: F401  (registers repro_torch::all_to_all)

    c10d = torch.ops.c10d
    return {
        c10d.allreduce_.default: ("all-reduce", 1, False),
        c10d.allgather_.default: ("all-gather", 2, False),
        c10d._reduce_scatter_base_.default: ("reduce-scatter", 2, False),
        c10d.send.default: ("collective-permute", 1, False),
        torch.ops.repro_torch.all_to_all.default: ("all-to-all", 1, True),
    }


def _group(arg):
    """The process group an operator's argument names."""
    from torch._C._distributed_c10d import ProcessGroup
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(arg) if isinstance(arg, str) else ProcessGroup.unbox(arg)


class StepCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts, for every operation that reaches it: the bytes it reads and
    writes (views and allocations without writes move none), each
    collective (kind, bytes, group size), and the live bytes of every
    storage an operation makes, from its first output until Python frees
    it, with their peak. ``hold`` adds storages that exist before the step
    (its arguments)."""

    #: aten operators that move no data: allocations without a write, and
    #: views that ``is_view`` does not mark. Operators outside aten (``prim``
    #: metadata queries) move none either.
    NO_TRAFFIC = ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
                  "_unsafe_view", "lift_fresh", "_local_scalar_dense")

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.collectives: List[Dict[str, Any]] = []
        self.live = 0
        self.peak = 0
        self._held: Dict[Any, Tuple[Any, int]] = {}
        self._table = _collective_ops()

    def hold(self, tree) -> int:
        """Track the storages of ``tree``'s tensors; their bytes."""
        before = self.live
        for t in _tensors(tree):
            self._track(t)
        return self.live - before

    def _track(self, t: torch.Tensor) -> None:
        st, key = t.untyped_storage(), _key(t)
        if key in self._held:
            return
        n = -(-st.nbytes() // ALLOCATION) * ALLOCATION

        def free(_, key=key, n=n):
            if self._held.pop(key, None) is not None:
                self.live -= n

        self._held[key] = (weakref.ref(st, free), n)
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        spec = self._table.get(func)
        if spec is not None:
            kind, at, result = spec
            group = _group(args[at])
            self.collectives.append({
                "kind": kind, "bytes": sum(map(_nbytes, _tensors(out if result else args[0]))),
                "group": group.size(), "group_name": group.group_name})
        elif func.namespace == "aten" and not func.is_view and \
                func.__name__.split(".")[0] not in self.NO_TRAFFIC:
            self.bytes += sum(map(_nbytes, _tensors((args, kwargs, out))))
        for t in _tensors(out):
            self._track(t)
        return out


# ---------------------------------------------------------------------------
# the fake group, its meshes and the fake tensors
# ---------------------------------------------------------------------------

_MESHES: Dict[Tuple[Tuple[int, ...], Tuple[str, ...], str], Any] = {}


def start_fake_group(world: int) -> None:
    """A fake process group of ``world`` ranks, this process rank 0: its
    collectives return at once and move nothing."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_world_size() != world or dist.get_backend() != "fake":
            raise RuntimeError("this process already holds a %s group of %d ranks; a dry-run "
                               "of %d ranks needs a process of its own"
                               % (dist.get_backend(), dist.get_world_size(), world))
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def fake_mesh(shape: Sequence[int], axes: Sequence[str], device: str):
    """A mesh of ``shape`` over a fake group of as many ranks (one mesh of
    each shape per process)."""
    from .mesh import make_mesh

    key = (tuple(shape), tuple(axes), torch.device(device).type)
    if key not in _MESHES:
        start_fake_group(math.prod(shape))
        _MESHES[key] = make_mesh(shape, axes, device=device)
    return _MESHES[key]


def production_mesh(multi_pod: bool, device: str):
    from .mesh import PRODUCTION_SHAPE

    return fake_mesh(*PRODUCTION_SHAPE[bool(multi_pod)], device=device)


@contextlib.contextmanager
def _fake_tensors():
    """``FakeTensorMode``, leaving no fake tensor in a cache that real
    tensors meet later (RoPE's frequencies)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..models import layers

    layers._rope_freqs.cache_clear()
    try:
        with FakeTensorMode(allow_non_fake_inputs=True):
            yield
    finally:
        layers._rope_freqs.cache_clear()


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------

def prepare_step(cfg, shape: ShapeConfig, mesh, rules, device, generator=None):
    """Rank 0's step of a cell, ready to run once: (arguments, the batch
    rows among them, run). ``generator`` (on ``device``) draws the
    parameters; without it they keep what their allocation held."""
    from ..distributed.sharding import batch_partition, spec_axes
    from ..models.model import build_model
    from ..models.transformer import ModelContext
    from ..serve.serve_step import _map_tree, make_serve_steps
    from ..train.optimizer import AdamWConfig, init_opt_state
    from ..train.train_step import local_rows, make_train_step, param_shardings, place_model

    model = build_model(cfg, device=device)
    if generator is not None:
        model.init(generator)
    specs = input_specs(cfg, shape)
    batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=device) for k, v in specs.items()}
    rows = spec_axes(batch_partition(mesh, shape.global_batch))
    if shape.kind == "train":
        params = model.param_tree()
        opt = init_opt_state(params)
        step, _ = make_train_step(model, mesh, rules, AdamWConfig(total_steps=1000))
        opt = step.place_opt_state(opt)
        return [params, opt], local_rows(mesh, step.ctx.batch_axes, batch), \
            lambda: step(params, opt, batch)
    if shape.kind == "prefill":
        place_model(model, param_shardings(model, mesh, rules))
        ctx = ModelContext(mesh, rules)
        local = local_rows(mesh, rows, batch)
        return [model.param_tree()], local, \
            lambda: torch.inference_mode()(model.prefill)(local, ctx)
    _, decode_fn, caches_abstract, shardings = make_serve_steps(
        model, mesh, rules, batch=shape.global_batch, max_len=shape.seq_len)
    caches = _map_tree(lambda a, sh: torch.zeros(sh.local_shape(a.shape), dtype=a.dtype,
                                                 device=device),
                       caches_abstract, shardings["caches"])
    params = model.param_tree()
    pos = shape.seq_len - 1  # an int here; an int32 scalar argument of the JAX step, held as one
    return [params, caches, torch.tensor(pos, dtype=torch.int32, device=device)], \
        local_rows(mesh, rows, batch), lambda: decode_fn(params, batch["tokens"], caches, pos)


def _storage_bytes(tree) -> int:
    """The bytes of the distinct storages of ``tree``'s tensors."""
    return sum({_key(t): t.untyped_storage().nbytes() for t in _tensors(tree)}.values())


def run_step(cfg, shape: ShapeConfig, mesh, *, device: str = "cuda", fake: bool = True,
             rules=None) -> Dict[str, Any]:
    """Run rank 0's step of ``cfg`` at ``shape`` on ``mesh`` (over a fake
    group) once and count it. ``fake``: on fake tensors (the dry-run);
    else on real tensors on ``device``, whose values mean nothing (the
    collectives move no data) but whose shapes and work are the step's.
    Each collective's record names the mesh axis of its group."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..distributed.sharding import default_rules

    rules = rules or default_rules(mesh)
    axes = {mesh.get_group(a).group_name: a for a in mesh.mesh_dim_names}
    with _fake_tensors() if fake else contextlib.nullcontext():
        args, rows, run = prepare_step(cfg, shape, mesh, rules, device)
        arg_bytes = _storage_bytes(args) + sum(map(_nbytes, _tensors(rows)))
        counter = StepCounter()
        counter.hold((args, rows))
        held = set(counter._held)
        flops = FlopCounterMode(display=False)
        t0 = time.perf_counter()
        with flops, counter:
            out = run()
        run_s = time.perf_counter() - t0
        del run, args
    for c in counter.collectives:
        c["axis"] = axes.get(c.pop("group_name"))
    return {
        "flops": float(flops.get_total_flops()),
        "bytes": float(counter.bytes),
        "collectives": counter.collectives,
        "argument_size_in_bytes": int(arg_bytes),
        "output_size_in_bytes": _storage_bytes([t for t in _tensors(out)
                                                if _key(t) not in held]),
        "peak_bytes": int(counter.peak),
        "run_s": run_s,
    }


def _layer_variants(cfg):
    """Two reduced-layer configs for per-layer cost extrapolation.

    The JAX package needs them because XLA's cost analysis counts a scan
    body once; the port's eager step counts every layer, so the
    extrapolation from two depths reproduces the direct count (a check of
    the counts, ``calibrate_cell``)."""
    if cfg.slstm_every:  # xlstm: layer count quantized to groups
        g = cfg.slstm_every
        return (
            dataclasses.replace(cfg, n_layers=g, scan_unroll=True),
            dataclasses.replace(cfg, n_layers=2 * g, scan_unroll=True),
            cfg.n_layers,
            g,
            2 * g,
        )
    if cfg.encoder_layers:  # whisper: encoder+decoder scale together
        return (
            dataclasses.replace(cfg, n_layers=1, encoder_layers=1, scan_unroll=True),
            dataclasses.replace(cfg, n_layers=2, encoder_layers=2, scan_unroll=True),
            cfg.n_layers,
            1,
            2,
        )
    fd = cfg.first_dense_layers
    return (
        dataclasses.replace(cfg, n_layers=fd + 1, scan_unroll=True),
        dataclasses.replace(cfg, n_layers=fd + 2, scan_unroll=True),
        cfg.n_layers,
        fd + 1,
        fd + 2,
    )


def _measure(cfg, shape, mesh, rules, n_chips, device: str = "cuda") -> Dict[str, float]:
    """Run one variant; return (flops, bytes, wire) per chip."""
    del n_chips  # each collective carries its own group size
    m = run_step(cfg, shape, mesh, device=device, rules=rules)
    return {"flops": m["flops"], "bytes": m["bytes"],
            "wire": float(collective_wire_bytes(m["collectives"])["total"])}


def calibrate(cfg, shape, mesh, rules, n_chips, device: str = "cuda") -> Dict[str, Any]:
    """Flops, bytes and wire of ``cfg`` extrapolated from its two
    ``_layer_variants`` to its depth, with their roofline terms."""
    cfg1, cfg2, L, l1, l2 = _layer_variants(cfg)
    m1 = _measure(cfg1, shape, mesh, rules, n_chips, device)
    m2 = _measure(cfg2, shape, mesh, rules, n_chips, device)
    out: Dict[str, Any] = {}
    for k in ("flops", "bytes", "wire"):
        per_layer = max(0.0, (m2[k] - m1[k]) / (l2 - l1))
        out[k] = m2[k] + per_layer * (L - l2)
        out[k + "_per_layer"] = per_layer
    terms = roofline_terms(
        {"flops": out["flops"], "bytes accessed": out["bytes"]}, {"total": out["wire"]}
    )
    out["roofline"] = {k: (v if isinstance(v, str) else float(v)) for k, v in terms.items()}
    return out


def calibrate_cell(arch: str, shape_name: str, *, multi_pod: bool,
                   device: str = "cuda") -> Dict[str, Any]:
    """Per-layer extrapolated roofline terms (see _layer_variants)."""
    from ..distributed.sharding import default_rules

    mesh = production_mesh(multi_pod, device)
    return calibrate(get_config(arch), SHAPES[shape_name], mesh, default_rules(mesh),
                     512 if multi_pod else 256, device)


def cell_result(cfg, shape: ShapeConfig, m: Dict[str, Any], n_chips: int) -> Dict[str, Any]:
    """The JSON fields of a counted step (``run_step``'s output)."""
    wire = collective_wire_bytes(m["collectives"])
    counts = wire.pop("counts")
    cost = {"flops": m["flops"], "bytes accessed": m["bytes"]}
    terms = roofline_terms(cost, wire)
    terms["basis"] = BASIS  # type: ignore[assignment]
    mflops = model_flops(cfg, shape)
    per_chip_model_flops = mflops / n_chips
    memory = {k: m[k] for k in ("argument_size_in_bytes", "output_size_in_bytes")}
    memory["temp_size_in_bytes"] = m["peak_bytes"] - m["argument_size_in_bytes"]
    memory["peak_bytes"] = m["peak_bytes"]
    return dict(
        status="ok",
        run_s=round(m["run_s"], 2),
        memory=memory,
        fits_h100=bool(m["peak_bytes"] <= HBM_BYTES),
        cost=cost,
        collectives={k: float(v) for k, v in wire.items()},
        collective_counts=counts,
        roofline={k: (v if isinstance(v, str) else float(v)) for k, v in terms.items()},
        model_flops_total=float(mflops),
        model_flops_per_chip=float(per_chip_model_flops),
        useful_flops_fraction=(per_chip_model_flops / terms["flops"] if terms["flops"] else 0.0),
        n_chips=n_chips,
    )


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               device: str = "cuda") -> Dict[str, Any]:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    cell: Dict[str, Any] = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "kind": shape.kind,
    }
    if not ok:
        cell["status"] = "skipped"
        cell["reason"] = reason
        return cell
    mesh = production_mesh(multi_pod, device)
    try:
        m = run_step(cfg, shape, mesh, device=device)
    except NotImplementedError as exc:
        cell["status"] = "unsupported"
        cell["reason"] = str(exc)
        return cell
    cell.update(cell_result(cfg, shape, m, 512 if multi_pod else 256))
    return cell


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

def _sweep(args, multi_pod: bool, archs, shapes, results: Dict[str, Any]) -> None:
    mesh_key = "multi" if multi_pod else "single"
    for arch in archs:
        for shape_name in shapes:
            key = f"{arch}|{shape_name}|{mesh_key}"
            if args.calibrate:
                cell = results.get(key)
                if cell is None or cell.get("status") != "ok":
                    continue
                if "calibrated" in cell and not args.force:
                    print(f"[dryrun] {key}: calibrated (cached)")
                    continue
                print(f"[dryrun] {key}: calibrating...", flush=True)
                try:
                    cell["calibrated"] = calibrate_cell(arch, shape_name, multi_pod=multi_pod,
                                                        device=args.device)
                    r = cell["calibrated"]["roofline"]
                    print(
                        f"[dryrun] {key}: calibrated compute={r['t_compute']:.3e}s "
                        f"memory={r['t_memory']:.3e}s collective={r['t_collective']:.3e}s "
                        f"dominant={r['dominant']}",
                        flush=True,
                    )
                except Exception as exc:  # noqa: BLE001
                    cell["calibrated"] = {"error": f"{type(exc).__name__}: {exc}"}
                    print(f"[dryrun] {key}: calibration error {exc}", flush=True)
                _write(args.out, results)
                continue
            if key in results and results[key].get("status") in ("ok", "skipped", "unsupported") \
                    and not args.force:
                print(f"[dryrun] {key}: cached ({results[key]['status']})")
                continue
            print(f"[dryrun] {key}: running...", flush=True)
            try:
                cell = lower_cell(arch, shape_name, multi_pod=multi_pod, device=args.device)
            except Exception as exc:  # noqa: BLE001 — recorded, not fatal
                cell = {
                    "arch": arch,
                    "shape": shape_name,
                    "mesh": "2x16x16" if multi_pod else "16x16",
                    "status": "error",
                    "error": f"{type(exc).__name__}: {exc}",
                    "traceback": traceback.format_exc()[-2000:],
                }
            results[key] = cell
            _write(args.out, results)
            status = cell["status"]
            extra = ""
            if status == "ok":
                r = cell["roofline"]
                extra = (
                    f" compute={r['t_compute']:.3e}s memory={r['t_memory']:.3e}s "
                    f"collective={r['t_collective']:.3e}s dominant={r['dominant']} "
                    f"peak={cell['memory']['peak_bytes'] / 1e9:.2f}GB run={cell['run_s']:.1f}s"
                )
            elif status == "unsupported":
                extra = f" ({cell['reason']})"
            print(f"[dryrun] {key}: {status}{extra}", flush=True)


def _write(path: str, results: Dict[str, Any]) -> None:
    with open(path, "w") as f:
        json.dump(results, f, indent=1)


def _load(path: str, force: bool) -> Dict[str, Any]:
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    return {}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--force", action="store_true")
    ap.add_argument(
        "--calibrate",
        action="store_true",
        help="add per-layer-extrapolated roofline terms to existing ok cells",
    )
    ap.add_argument("--device", default="cuda",
                    help="where the fake tensors lie (cuda | cpu); nothing runs on either")
    return ap


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    archs = sorted(all_configs()) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("dryrun: --device %s needs a CUDA device; pass --device cpu"
                         % args.device)

    if args.mesh == "both":  # a fake group per process: one process per mesh
        argv = list(sys.argv[1:] if argv is None else argv)
        i = argv.index("--mesh") if "--mesh" in argv else None
        if i is not None:
            del argv[i : i + 2]
        if args.force:  # the first process starts the file afresh, the second adds to it
            argv.remove("--force")
        src = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (src, os.environ.get("PYTHONPATH")) if p))
        for n, mesh in enumerate(("single", "multi")):
            extra = ["--force"] if args.force and n == 0 else []
            rc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
                                 "--mesh", mesh, *extra], env=env).returncode
            if rc not in (0, 1):  # 1: cells with errors, counted below
                raise SystemExit("dryrun: the %s mesh's process failed (exit %d)" % (mesh, rc))
        results = _load(args.out, False)
    else:
        results = _load(args.out, args.force)
        _sweep(args, args.mesh == "multi", archs, shapes, results)
        _write(args.out, results)

    statuses = [c["status"] for c in results.values()]
    n_err = statuses.count("error")
    print(f"[dryrun] done: {statuses.count('ok')} ok, {statuses.count('unsupported')} "
          f"unsupported, {statuses.count('skipped')} skipped-by-design, {n_err} errors")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
