"""Multi-rank cases that hold repro_torch against the JAX package on the CPU.

Each case runs twice from one numpy seed: in the port, on gloo ranks (one
process per rank, a ``file://`` store under the test's temporary
directory, never a fixed port), and in the JAX package, in one process
with ``--xla_force_host_platform_device_count`` host devices, as
``tests/test_pipeline_parallel.py`` runs it. The parameters come from
``numpy_params``, the same draws in both processes. Each side pickles a
dict of numpy arrays per case (the port's from rank 0, which gathers);
the tests compare them.

    python tests/_mesh_cases.py torch CASES WORLD RANK STORE OUT
    python tests/_mesh_cases.py jax CASES DEVICES OUT
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OPT = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
STEPS = {"granite-3-2b": 3, "deepseek-moe-16b": 4, "deepseek-v2-236b": 3, "hymba-1.5b": 3,
         "xlstm-350m": 3}
SERVE_PROMPT, SERVE_NEW = 16, 8


# ---------------------------------------------------------------------------
# shared inputs
# ---------------------------------------------------------------------------

def _entries(defs, path=()):
    if isinstance(defs, dict):
        for k in sorted(defs):
            yield from _entries(defs[k], path + (k,))
    else:
        yield path, defs


def numpy_params(defs, seed: int, *, soften: bool = False, fp32: bool = False):
    """A parameter tree of numpy arrays for either package's ``defs`` (the
    same shapes, initializers and dtypes): normal x scale (1/sqrt(fan_in)
    by default), zeros or ones, drawn in sorted path order; bf16 leaves as
    ``ml_dtypes.bfloat16``. ``soften`` divides the query and key weights by
    8 (wq, wk; MLA's w_uq, w_uk): near-hard attention at smoke width,
    tests/test_torch_train.py; ``fp32`` casts
    every leaf to fp32 after its bf16 rounding (as the fp32 train tests
    cast a bf16 init)."""
    import ml_dtypes

    rng = np.random.default_rng(seed)
    out: dict = {}
    for path, d in _entries(defs):
        shape = tuple(d.shape)
        if d.init == "zeros":
            a = np.zeros(shape, np.float32)
        elif d.init == "ones":
            a = np.ones(shape, np.float32)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            scale = d.scale if d.scale is not None else 1.0 / np.sqrt(max(1, fan_in))
            a = (rng.standard_normal(shape, np.float32) * np.float32(scale)).astype(np.float32)
        if soften and path[-1] in ("wq", "wk", "w_uq", "w_uk"):
            a = a / 8
        if "bfloat16" in str(d.dtype):
            a = a.astype(ml_dtypes.bfloat16)
            if fp32:
                a = a.astype(np.float32)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a
    return out


def batches(vocab: int, n: int, rows: int = 4, seq: int = 33):
    rng = np.random.default_rng(5)
    return [{"tokens": rng.integers(0, vocab, (rows, seq), dtype=np.int32)} for _ in range(n)]


def moe_inputs(cf: float):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((4, 32, 128), np.float32)
    return x, dict(top_k=2, capacity_factor=cf, activation="silu")


def pipeline_inputs():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((4, 16, 16), np.float32) * np.float32(0.3)
    x = rng.standard_normal((8, 2, 16), np.float32)
    return w, x


def psum_inputs():
    rng = np.random.default_rng(7)
    scales = np.array([1.0, 10.0, 0.01, 3.0], np.float32)[:, None]
    return (rng.standard_normal((4, 33), np.float32) * scales).astype(np.float32)


def embed_inputs():
    import ml_dtypes

    rng = np.random.default_rng(9)
    table = rng.standard_normal((512, 128), np.float32).astype(ml_dtypes.bfloat16)
    return table, rng.integers(0, 512, (4, 16), dtype=np.int32)


def train_case(name: str):
    """(arch, dtype, compressed gradients) of a case named ``granite_fp32``,
    ``deepseek_bf16``, ``granite_compressed`` (fp32)..."""
    arch, kind = name.rsplit("_", 1)
    arch = {"granite": "granite-3-2b", "deepseek": "deepseek-moe-16b",
            "deepseekv2": "deepseek-v2-236b", "hymba": "hymba-1.5b", "xlstm": "xlstm-350m"}[arch]
    return arch, "fp32" if kind == "compressed" else kind, kind == "compressed"


# ---------------------------------------------------------------------------
# the port's side, on gloo ranks
# ---------------------------------------------------------------------------

def _torch_cfg(arch, dtype, **replaced):
    import torch

    from repro_torch.configs import all_configs, smoke_config

    cfg = dataclasses.replace(smoke_config(all_configs()[arch]), **replaced)
    wide = {"fp32": torch.float32, "fp64": torch.float64}.get(dtype)
    return dataclasses.replace(cfg, dtype=wide) if wide else cfg


def _torch_model(arch, dtype, seed=3, soften=None, **replaced):
    """``arch`` at smoke width (fields of the config ``replaced``), its
    parameters from ``numpy_params``."""
    import torch

    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.model import model_defs

    cfg = _torch_cfg(arch, dtype, **replaced)
    tree = numpy_params(model_defs(cfg), seed, soften=dtype == "fp32" if soften is None
                        else soften)
    model = params_from_jax(cfg, tree, device="cpu")
    if dtype in ("fp32", "fp64"):
        model.to(cfg.dtype)
    model.cfg = cfg
    return model


def gathered(tree, shardings):
    """A tree of blocks (per-layer lists of blocks, or stacked blocks) as
    the JAX package's whole stacked arrays, fp32 numpy."""
    import torch

    from repro_torch.models.layers import map_members, stack_depth, stacked

    if isinstance(tree, dict):
        return {k: gathered(tree[k], shardings[k]) for k in tree}
    if isinstance(tree, list):
        depth = stack_depth(tree)
        t = stacked(map_members(lambda m: shardings.layer(depth).gather(m), tree))
    else:
        t = shardings.gather(tree)
    return t.detach().to(torch.float32).numpy()


def torch_case(name: str):
    import torch

    from repro_torch.distributed import compressed_psum, default_rules
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.distributed.sharding import NamedSharding, P
    from repro_torch.launch.mesh import make_mesh

    if name == "pipeline":
        mesh = make_mesh((4,), ("pod",), device="cpu")
        w, x = pipeline_inputs()
        mine = NamedSharding(mesh, P("pod")).shard(torch.from_numpy(w))  # this stage only
        out = pipeline_apply(lambda p, v: torch.tanh(v @ p["w"]), {"w": mine},
                             torch.from_numpy(x), mesh=mesh, axis="pod")
        ref = torch.from_numpy(x)
        for s in range(4):
            ref = torch.tanh(ref @ torch.from_numpy(w[s]))
        return {"out": out.numpy(), "sequential": ref.numpy()}
    if name == "psum":
        mesh = make_mesh((4,), ("data",), device="cpu")
        x = torch.from_numpy(psum_inputs()[mesh.get_local_rank("data")])
        return {"out": compressed_psum(x, "data", mesh=mesh).numpy()}
    if name == "embed":
        from repro_torch.models.convert import to_tensor
        from repro_torch.models.transformer import ModelContext, sharded_embed_lookup

        mesh = make_mesh((1, 4), ("data", "model"), device="cpu")
        table, tokens = embed_inputs()
        local = NamedSharding(mesh, P("model", None)).shard(to_tensor(table))
        out = sharded_embed_lookup(ModelContext(mesh, default_rules(mesh)), local,
                                   torch.from_numpy(tokens).long(), table.shape[0])
        return {"out": out.float().numpy(), "local_rows": np.int64(local.shape[0])}
    if name.startswith("moe"):
        return _torch_moe(float(name.split("_")[1]))
    if name.startswith(("granite", "deepseek", "hymba", "xlstm")):
        return _torch_train(name)
    if name == "grads":
        return {arch: _grads_on(arch, shape) for arch, shape in GRADS.items()}
    if name == "tp_grads":
        return _torch_tp_grads()
    if name == "serve":
        return {k: v for arch, dtype in SERVE for k, v in _serve_on(
            arch, dtype, (2, 2), SERVE_PROMPT, SERVE_NEW).items()}
    if name == "tp_serve":
        return {k: v for tag, arch, shape, replaced in TP_SERVE for dtype in ("fp32", "fp64")
                for k, v in _serve_on(arch, dtype, shape, TP_PROMPT, TP_NEW,
                                      tag="%s_%s" % (tag, dtype), **replaced).items()}
    if name == "restore":
        return _torch_restore()
    if name == "remat_a2a":
        return _torch_remat_a2a()
    raise ValueError(name)


def _torch_remat_a2a():
    """deepseek-moe-16b (smoke width, fp32) on (data, model) = (2, 1),
    ep = 2: the MoE all-to-alls of one forward and of its backward under
    each remat policy, counted by the dry-run's collective counter."""
    import torch

    from repro_torch.distributed import default_rules
    from repro_torch.launch.dryrun import StepCounter
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import tree_tensors
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.train_step import local_rows

    mesh = make_mesh((2, 1), ("data", "model"), device="cpu")
    model = _torch_model("deepseek-moe-16b", "fp32")
    cfg = model.cfg
    step, _ = make_train_step(model, mesh, default_rules(mesh), AdamWConfig(**OPT))
    batch = local_rows(mesh, ("data",), {k: torch.from_numpy(v)
                                         for k, v in batches(cfg.vocab_size, 1)[0].items()})
    params = tree_tensors(model.param_tree())
    out = {"moe_layers": np.int64(cfg.n_layers - cfg.first_dense_layers)}
    for policy in ("none", "dots", "dots_plus_collectives"):
        model.cfg = dataclasses.replace(cfg, remat_policy=policy)
        counts = []
        with StepCounter() as fwd:
            loss, _ = model.loss(batch, step.ctx)
        with StepCounter() as bwd:
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        for c in (fwd, bwd):
            counts.append(sum(1 for r in c.collectives if r["kind"] == "all-to-all"))
        out[policy] = np.array(counts)
        out[policy + "_loss"] = loss.detach().numpy()
        out[policy + "_grads"] = [np.zeros(0) if g is None else g.numpy() for g in grads]
    return out


def _torch_moe(cf: float):
    import torch

    from repro_torch.distributed import default_rules
    from repro_torch.distributed.sharding import NamedSharding, P
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.convert import to_tensor
    from repro_torch.models.moe import moe_defs, moe_layer
    from repro_torch.train.train_step import local_rows

    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    rules = default_rules(mesh)
    defs = moe_defs(0, 128, 8, 64, 0)
    params = numpy_params(defs, 13, fp32=True)
    local = {k: NamedSharding(mesh, rules.spec(defs[k].logical)).shard(to_tensor(v))
             for k, v in params.items()}
    x, kw = moe_inputs(cf)
    x_l = local_rows(mesh, ("data",), {"x": torch.from_numpy(x)})["x"].requires_grad_(True)
    y, aux = moe_layer(local, x_l, mesh=mesh, dp_axes=("data",), **kw)
    (y.square().sum() + aux).backward()
    rows = NamedSharding(mesh, P("data"))
    return {"y": rows.gather(y.detach()).numpy(), "aux": aux.detach().numpy(),
            "dx": rows.gather(x_l.grad).numpy(), "local_experts": np.int64(local["w_up"].shape[0])}


def _torch_train(name: str):
    from repro_torch.distributed import default_rules
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.distributed import init_error_state
    from repro_torch.train import AdamWConfig, init_opt_state, make_train_step

    arch, dtype, compress = train_case(name)
    shape, axes = ((2, 2, 2), ("pod", "data", "model")) if arch.startswith("deepseek") else \
        ((2, 2), ("data", "model"))
    mesh = make_mesh(shape, axes, device="cpu")
    model = _torch_model(arch, dtype)
    params = model.param_tree()
    opt = init_opt_state(params)
    if compress:
        opt["grad_error"] = init_error_state(params)
    step, shardings = make_train_step(model, mesh, default_rules(mesh), AdamWConfig(**OPT),
                                      compress_grads=compress)
    losses, norms = [], []
    for batch in batches(model.cfg.vocab_size, STEPS[arch]):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    local = {"/".join(p): tuple(leaf.shape) for p, leaf in _entries(opt["m"])}
    return {"losses": np.array(losses), "grad_norms": np.array(norms),
            "params": gathered(params, shardings["params"]),
            "m": gathered(opt["m"], shardings["opt"]["m"]), "moment_blocks": local}


SERVE = [("granite-3-2b", "fp32"), ("granite-3-2b", "bf16"), ("gemma-2b", "fp32"),
         ("deepseek-v2-236b", "fp32"), ("deepseek-moe-16b", "fp32"), ("hymba-1.5b", "fp32"),
         ("hymba-1.5b", "fp64"), ("whisper-tiny", "fp32")]


GRADS = {"granite-3-2b": (2, 2), "gemma-2b": (2, 2), "qwen2.5-32b": (2, 2),
         "internlm2-20b": (2, 2), "hymba-1.5b": (2, 2), "internvl2-76b": (2, 2),
         "whisper-tiny": (2, 2), "xlstm-350m": (2, 2)}
#: Tensor parallelism of the xLSTM forms (with 2 heads on model = 4, each
#: rank's mLSTM cell one head and half its value columns), granite's and
#: qwen2.5's (with K/V biases) KV heads, which do not divide model = 4, and
#: the whole weights whose gradients each rank computes a quarter of
#: (``wgrad_split``): 5 query heads and a vocabulary of 514, which do not
#: divide 4 either (gemma's one KV head; whisper's self, cross and encoder
#: attention; deepseek-v2's MLA down projections, without experts): (tag,
#: arch, mesh shape, config fields replaced).
TP_GRADS = [("xlstm-350m", "xlstm-350m", (2, 2), {}), ("xlstm-350m", "xlstm-350m", (1, 4), {}),
            ("xlstm-350m-2heads", "xlstm-350m", (1, 4), dict(n_heads=2)),
            ("granite-3-2b", "granite-3-2b", (1, 4), {}),
            ("qwen2.5-32b", "qwen2.5-32b", (1, 4), {}),
            ("gemma-2b-whole", "gemma-2b", (1, 4), dict(n_heads=5, vocab_size=514)),
            ("whisper-tiny-whole", "whisper-tiny", (1, 4),
             dict(n_heads=5, n_kv_heads=5, head_dim=32, vocab_size=514)),
            ("deepseek-v2-236b-dense", "deepseek-v2-236b", (1, 4),
             dict(n_experts=0, vocab_size=514))]
#: The TP_GRADS tags whose FLOPs are counted with and without the split.
TP_SPLIT = ("gemma-2b-whole", "whisper-tiny-whole", "deepseek-v2-236b-dense")
#: Decode through the serve steps: (tag, arch, mesh shape, config fields
#: replaced). hymba's 64-slot ring splits over model; at smoke width its 4
#: heads split and its 2 KV heads stay whole, with 5 and 5 both stay whole.
TP_SERVE = [("xlstm-350m", "xlstm-350m", (2, 2), {}),
            ("xlstm-350m-2heads", "xlstm-350m", (1, 4), dict(n_heads=2)),
            ("hymba-1.5b", "hymba-1.5b", (1, 4), {}),
            ("hymba-1.5b-5heads", "hymba-1.5b", (1, 4),
             dict(n_heads=5, n_kv_heads=5, head_dim=32))]
TP_PROMPT, TP_NEW = 48, 40  # max_len 96: the ring wraps past 64


def _grads_on(arch, shape, products=None, replaced=None, flops=None):
    """The loss and every parameter's gradient of one fp32 batch (attention
    softened) on a (data, model) mesh of ``shape``, summed over data and
    gathered over model, against one device: the mesh's forward and
    backward collectives for the families without experts (whose aux loss
    and capacity depend on the mesh). ``products``: a dict that receives
    the shapes of the products with layer 0's ``wk`` and ``wv`` on the
    mesh. ``replaced``: config fields. ``flops``: a dict that receives the
    FLOPs of the mesh's loss and gradients (``split``), and again with
    ``collectives.split_weight_grad_einsum`` a plain einsum (``whole``)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.distributed import collectives, default_rules
    from repro_torch.distributed.sharding import spec_axes
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import leaf_paths, stack_depth, tree_tensors
    from repro_torch.models.transformer import ModelContext
    from repro_torch.train.train_step import local_rows, param_shardings, place_model

    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    rules = default_rules(mesh)
    batch = {"tokens": torch.from_numpy(batches(512, 1)[0]["tokens"]).long()}
    runs = []
    for on_mesh in (False, True):
        model = _torch_model(arch, "fp32", **(replaced or {}))
        cfg = model.cfg
        extra = {"audio": ("frames", cfg.encoder_frames),
                 "vlm": ("patches", cfg.vision_tokens)}.get(cfg.family)
        if extra:
            batch[extra[0]] = torch.from_numpy(np.random.default_rng(6).standard_normal(
                (4, extra[1], cfg.d_model), np.float32))
        model.requires_grad_(True)
        if not on_mesh:
            loss, _ = model.loss(batch)
            runs.append((float(loss), [g.numpy() for g in torch.autograd.grad(
                loss, tree_tensors(model.param_tree()))]))
            continue
        shardings = param_shardings(model, mesh, rules)
        place_model(model, shardings)
        ctx = ModelContext(mesh, rules)
        if flops is not None:
            split = collectives.split_weight_grad_einsum
            for key in ("whole", "split"):
                collectives.split_weight_grad_einsum = split if key == "split" else (
                    lambda eq, x, w, mesh, axis="model": torch.einsum(eq, x, w))
                try:
                    with FlopCounterMode(display=False) as count:
                        loss, _ = model.loss(local_rows(mesh, ("data",), batch), ctx)
                        grads = torch.autograd.grad(loss, tree_tensors(model.param_tree()))
                finally:
                    collectives.split_weight_grad_einsum = split
                flops[key] = count.get_total_flops()
            del grads
            loss, _ = model.loss(local_rows(mesh, ("data",), batch), ctx)
        elif products is None:
            loss, _ = model.loss(local_rows(mesh, ("data",), batch), ctx)
        else:
            attn = model["layers"][0]["attn"]
            with _product_shapes({"wk": attn["wk"], "wv": attn["wv"]}) as seen:
                loss, _ = model.loss(local_rows(mesh, ("data",), batch), ctx)
            products.update({k: np.array(v) for k, v in seen.shapes.items()})
        grads = iter(torch.autograd.grad(loss, tree_tensors(model.param_tree())))
        full = []
        for path, _ in leaf_paths(model.defs):
            sh = shardings
            for k in path:
                sh = sh[k]
            leaf = model.param_leaf(path)
            layer = sh.layer(stack_depth(leaf))
            for _ in tree_tensors({"x": leaf}):
                g = next(grads).clone()
                if "data" not in spec_axes(sh.spec):
                    torch.distributed.all_reduce(g, group=mesh.get_group("data"))
                full.append(layer.gather(g).numpy())
        runs.append((float(loss), full))
    return runs + [[path[-1] for path, d in leaf_paths(model.defs)
                    for _ in range(int(np.prod(d.shape[:stack_depth(
                        model.param_leaf(path))])))]]


def _product_shapes(weights):
    """A dispatch mode that records the output shape of each matrix
    product one of whose operands shares a storage with ``weights[name]``
    (a view of it: a slice, or the reshape ``einsum`` makes), by name."""
    import torch
    from torch.multiprocessing.reductions import StorageWeakRef
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten
    dots = {aten.mm.default, aten.bmm.default, aten.addmm.default, aten.baddbmm.default}
    keys = {StorageWeakRef(w.untyped_storage()): name for name, w in weights.items()}

    class Mode(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.shapes = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func in dots:
                for a in args:
                    name = keys.get(StorageWeakRef(a.untyped_storage())) \
                        if isinstance(a, torch.Tensor) else None
                    if name is not None:
                        self.shapes.setdefault(name, []).append(tuple(out.shape))
            return out

    return Mode()


def _torch_tp_grads():
    out = {}
    for tag, arch, shape, replaced in TP_GRADS:
        products = {} if tag == "granite-3-2b" else None
        flops = {} if tag in TP_SPLIT else None
        key = "%s@%dx%d" % ((tag,) + shape)
        out[key] = _grads_on(arch, shape, products, replaced, flops)
        if products is not None:
            out[key + "/products"] = products
        if flops is not None:
            out[key + "/flops"] = flops
    return out


def _serve_on(arch, dtype, shape, prompt, new, tag=None, **replaced):
    """Greedy decode on a (data, model) mesh of ``shape`` and on one device
    from the same weights (attention softened): ``prompt`` tokens, then
    ``new`` tokens; the cache blocks each rank holds at the end."""
    import torch

    from repro_torch.distributed import default_rules
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve import make_serve_steps, prefill_to_decode_caches

    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    tag = tag or "%s_%s" % (arch, dtype)
    out, runs = {}, []
    for on_mesh in (False, True):
        model = _torch_model(arch, dtype, seed=21, soften=True, **replaced)
        cfg = model.cfg
        B, max_len = 4, prompt + new
        prompts = torch.from_numpy(np.random.default_rng(22).integers(
            0, cfg.vocab_size, (B, prompt))).long()
        if on_mesh:
            prefill, decode, _, shardings = make_serve_steps(
                model, mesh, default_rules(mesh), batch=B, max_len=max_len)
            params = model.param_tree()
            pre = lambda b: prefill(params, b)  # noqa: E731
            dec = lambda t, c, i: decode(params, t, c, i)  # noqa: E731
        else:
            pre, dec, _ = make_serve_steps(model, batch=B, max_len=max_len)
        inputs = {"tokens": prompts}
        if cfg.family == "audio":
            inputs["frames"] = torch.from_numpy(np.random.default_rng(23).standard_normal(
                (B, cfg.encoder_frames, cfg.d_model), np.float32))
        logits, pc = pre(inputs)
        caches = prefill_to_decode_caches(cfg, model, pc, B, max_len, prompt)
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        wide = torch.float64 if cfg.dtype == torch.float64 else torch.float32
        toks, steps = [tok], [logits[:, 0].to(wide)]
        for t in range(new - 1):
            tok, lg, caches = dec(tok, caches, prompt + t)
            toks.append(tok)
            steps.append(lg[:, 0].to(wide))
        runs.append((torch.cat(toks, 1).numpy(), torch.stack(steps, 1).numpy()))
        if on_mesh:
            if cfg.family == "ssm":
                held = caches["m"]
            else:
                held = caches["attn"] if "attn" in caches else caches[next(iter(caches))]["attn"]
            out[tag + "_cache_block"] = {k: np.array(v.shape) for k, v in held.items()}
    out[tag] = runs
    return out


def _torch_restore():
    import torch

    from repro_torch.checkpoint import latest_checkpoint, restore_checkpoint
    from repro_torch.distributed import default_rules
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import members, stack_depth
    from repro_torch.train import AdamWConfig, init_opt_state, make_train_step

    ckpt = Path(os.environ["JAX_CKPT"])
    deadline = time.monotonic() + 400
    while latest_checkpoint(str(ckpt)) is None or not (
            Path(latest_checkpoint(str(ckpt))) / "manifest.json").exists():
        if time.monotonic() > deadline:
            raise TimeoutError("no JAX checkpoint under %s" % ckpt)
        time.sleep(0.5)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    model = _torch_model("granite-3-2b", "bf16", seed=33)
    params = model.param_tree()
    opt = init_opt_state(params)
    step, shardings = make_train_step(model, mesh, default_rules(mesh), AdamWConfig(**OPT))
    opt = step.place_opt_state(opt)
    s, state = restore_checkpoint(latest_checkpoint(str(ckpt)), {"params": params, "opt": opt},
                                  shardings=shardings)
    placed = []
    for path, leaf in _entries(params):
        sh = shardings["params"]
        for k in path:
            sh = sh[k]
        full = gathered(leaf, sh)
        depth = stack_depth(leaf)
        blocks = [sh.layer(depth).shard(torch.from_numpy(f)) for f in
                  (full.reshape((-1,) + full.shape[depth:]) if depth else [full])]
        placed.append(all(torch.equal(m.float(), b) for m, b in zip(members(leaf), blocks))
                      and all(tuple(m.shape) == sh.layer(depth).local_shape(full.shape[depth:])
                              for m in members(leaf)))
    return {"step": np.int64(s), "params": gathered(state["params"], shardings["params"]),
            "m": gathered(state["opt"]["m"], shardings["opt"]["m"]),
            "opt_step": np.int64(int(state["opt"]["step"])), "placed": np.array(placed),
            "restored_in_place": np.bool_(state["params"]["embed"] is params["embed"])}


def torch_main(cases, world: int, rank: int, store: str, out: str) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        results = {name: torch_case(name) for name in cases}
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(results, f)


# ---------------------------------------------------------------------------
# the JAX package's side, on forced host devices
# ---------------------------------------------------------------------------

def _jax_strict(fn, *args, **kw):
    import jax

    return jax.jit(fn, **kw).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def jax_case(name: str, out_dir: Path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding as JNS
    from jax.sharding import PartitionSpec as JP

    from repro.distributed import compression, default_rules
    from repro.distributed.pipeline import pipeline_apply
    from repro.distributed.sharding import shard_map_compat
    from repro.launch.mesh import make_mesh
    from repro.models import ModelContext

    if name == "pipeline":
        mesh = make_mesh((4, 1), ("pod", "data"))
        w, x = pipeline_inputs()
        out = pipeline_apply(lambda p, v: jnp.tanh(v @ p["w"]), {"w": jnp.asarray(w)},
                             jnp.asarray(x), mesh=mesh, axis="pod")
        return {"out": np.asarray(out)}
    if name == "psum":
        mesh = make_mesh((4,), ("data",))
        fn = shard_map_compat(lambda v: compression.compressed_psum(v[0], "data")[None],
                              mesh=mesh, in_specs=(JP("data"),), out_specs=JP(),
                              check_vma=False)
        return {"out": np.asarray(jax.jit(fn)(jnp.asarray(psum_inputs())))[0]}
    if name == "embed":
        from repro.models.transformer import sharded_embed_lookup

        mesh = make_mesh((1, 4), ("data", "model"))
        table, tokens = embed_inputs()
        ctx = ModelContext(mesh, default_rules(mesh))
        fn = jax.jit(lambda t, k: sharded_embed_lookup(ctx, t, k))
        out = fn(jax.device_put(jnp.asarray(table), JNS(mesh, JP("model", None))),
                 jnp.asarray(tokens))
        return {"out": np.asarray(out.astype(jnp.float32))}
    if name.startswith("moe"):
        from repro.models.moe import moe_defs, moe_layer

        mesh = make_mesh((2, 2), ("data", "model"))
        params = jax.tree.map(jnp.asarray, numpy_params(moe_defs(0, 128, 8, 64, 0), 13,
                                                        fp32=True))
        x, kw = moe_inputs(float(name.split("_")[1]))

        def f(p, v):
            y, aux = moe_layer(p, v, mesh=mesh, dp_axes=("data",), **kw)
            return jnp.sum(jnp.square(y)) + aux, (y, aux)

        (_, (y, aux)), dx = jax.jit(jax.value_and_grad(f, argnums=1, has_aux=True))(
            params, jnp.asarray(x))
        return {"y": np.asarray(y), "aux": np.asarray(aux), "dx": np.asarray(dx)}
    if name.startswith(("granite", "deepseek", "hymba", "xlstm")):
        return _jax_train(name, out_dir)
    raise ValueError(name)


def _jax_train(name: str, out_dir: Path):
    import jax
    import jax.numpy as jnp

    from repro import checkpoint as jckpt
    from repro.configs import all_configs, smoke_config
    from repro.distributed import compression
    from repro.distributed import default_rules
    from repro.launch.mesh import make_mesh
    from repro.models import build_model
    from repro.train import AdamWConfig, make_train_step
    from repro.train import optimizer as jopt

    arch, dtype, compress = train_case(name)
    shape, axes = ((2, 2, 2), ("pod", "data", "model")) if arch.startswith("deepseek") else \
        ((2, 2), ("data", "model"))
    mesh = make_mesh(shape, axes)
    cfg = smoke_config(all_configs()[arch])
    if dtype == "fp32":
        cfg = dataclasses.replace(cfg, dtype=jnp.float32)
    model = build_model(cfg)
    params = jax.tree.map(jnp.asarray, numpy_params(model.defs, 3, soften=dtype == "fp32",
                                                    fp32=dtype == "fp32"))
    opt = jopt.init_opt_state(params)
    if compress:
        opt["grad_error"] = compression.init_error_state(params)
    step, shardings = make_train_step(model, mesh, default_rules(mesh), AdamWConfig(**OPT),
                                      compress_grads=compress)
    compiled, losses, norms = None, [], []
    for batch in batches(cfg.vocab_size, STEPS[arch]):
        b = jax.tree.map(jnp.asarray, batch)
        if compiled is None:
            compiled = step.lower(params, opt, b).compile(
                compiler_options={"xla_allow_excess_precision": False})
        params, opt, m = compiled(params, opt, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    specs = {"/".join(str(k.key) for k in p): tuple(s.spec)
             for p, s in jax.tree_util.tree_leaves_with_path(shardings["opt"]["m"])}
    if name == "granite_bf16":
        jckpt.save_checkpoint(str(out_dir / "jax-ckpt"), STEPS[arch],
                              {"params": params, "opt": opt})
    f32 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)  # noqa: E731
    return {"losses": np.array(losses), "grad_norms": np.array(norms), "params": f32(params),
            "m": f32(opt["m"]), "moment_specs": specs}


def jax_main(cases, devices: int, out: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=%d" % devices
    out_dir = Path(out).parent
    results = {name: jax_case(name, out_dir) for name in cases}
    with open(out, "wb") as f:
        pickle.dump(results, f)


# ---------------------------------------------------------------------------
# launching
# ---------------------------------------------------------------------------

class Launch:
    """Processes of one side started in the background; ``results()``
    waits for them (up to ``timeout`` s) and loads what they pickled."""

    def __init__(self, argvs, out: Path, timeout: float, env=None):
        self.out, self.timeout = out, timeout
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
                   OMP_NUM_THREADS="1", **(env or {}))
        self.logs = [out.with_suffix(".%d.log" % i) for i in range(len(argvs))]
        self.procs = [subprocess.Popen([sys.executable, __file__, *map(str, argv)], env=env,
                                       stdout=open(log, "w"), stderr=subprocess.STDOUT,
                                       cwd=str(ROOT))
                      for argv, log in zip(argvs, self.logs)]
        self.started = time.monotonic()
        self._results = None

    def results(self):
        if self._results is None:
            try:
                for p in self.procs:
                    p.wait(timeout=max(1.0, self.timeout - (time.monotonic() - self.started)))
            finally:
                for p in self.procs:
                    if p.poll() is None:
                        p.kill()
            bad = [(i, p.returncode) for i, p in enumerate(self.procs) if p.returncode]
            if bad or not self.out.exists():
                tails = "\n".join("--- %s (rc %s)\n%s" % (log.name, p.returncode,
                                                          log.read_text()[-3000:])
                                  for log, p in zip(self.logs, self.procs))
                raise AssertionError("a process failed: %s\n%s" % (bad, tails))
            with open(self.out, "rb") as f:
                self._results = pickle.load(f)
        return self._results


def start_torch(cases, world: int, tmp: Path, timeout: float = 300, env=None) -> Launch:
    tmp.mkdir(parents=True, exist_ok=True)
    store, out = tmp / "store", tmp / "torch.pkl"
    return Launch([("torch", ",".join(cases), world, rank, store, out) for rank in range(world)],
                  out, timeout, env)


def start_jax(cases, devices: int, tmp: Path, timeout: float = 300) -> Launch:
    tmp.mkdir(parents=True, exist_ok=True)
    out = tmp / "jax.pkl"
    return Launch([("jax", ",".join(cases), devices, out)], out, timeout)


if __name__ == "__main__":
    side, cases = sys.argv[1], sys.argv[2].split(",")
    if side == "torch":
        torch_main(cases, int(sys.argv[3]), int(sys.argv[4]), sys.argv[5], sys.argv[6])
    else:
        jax_main(cases, int(sys.argv[3]), sys.argv[4])
