"""repro_torch's sharded train and serve steps against the JAX package, on
gloo ranks on the CPU.

From one numpy seed (``tests/_mesh_cases.py``), the port on gloo ranks and
the JAX package on as many forced host devices:

  * granite-3-2b (smoke width) on (data, model) = (2, 2): TP over heads,
    FFN and vocabulary, DP with ZeRO-1; 3 steps;
  * deepseek-moe-16b (smoke width) on (pod, data, model) = (2, 2, 2), the
    JAX package's ``MULTIPOD_SCRIPT`` (tests/test_pipeline_parallel.py):
    EP all-to-alls over data, TP, ZeRO-1, pod as a second DP axis; 4 steps.

In fp32, with attention softened on both sides (wq, wk / 8;
tests/test_torch_train.py says why), losses and gradient norms agree to
1e-4 relative and every gathered parameter element to 1e-4 but at most
max(2, 1e-4 of a leaf) elements within 2 lr (the one-device test's bound;
measured: losses within 2e-7, parameters within 4.5e-5), the moments to
1e-4 of their leaf's largest; hymba-1.5b (smoke width) on (2, 2) the same
way, its SSM channels over model, and deepseek-v2-236b (MLA heads over
model, EP) on (2, 2, 2); granite also with int8-compressed gradients
(one scale per leaf, the max over every rank's block; 1e-3 of a leaf's
elements within 2 lr, the one-device compressed bound; the moments are not
compared there, as an int8 rounding that lands the other way moves an
element of m by a tenth of a quantization step). In bf16, as drawn, each loss within 3e-2
relative (the one-device bf16 bound; the bf16 gradient is summed across
ranks in another order than XLA's, and near-hard attention makes the
gradient norm itself ill-conditioned, so it is not compared; measured:
losses within 3.3e-3). The ZeRO-1 blocks each rank holds have the shape
the JAX package's moment specs give.

Then the port against itself: the loss and every gradient of one batch
on (2, 2) (the xLSTM's ``ssm_inner`` leaves over model) against one device
for the eight families without experts, and greedy decode through
``make_serve_steps(model, mesh, rules, ...)`` on (2, 2) against the
one-device serve steps, attention softened as above: granite-3-2b (KV
heads over model), gemma-2b (MQA) and deepseek-v2-236b (MLA), whose caches
split their sequence over model (flash-decode), deepseek-moe-16b (EP
all-to-alls in decode), hymba-1.5b (its SSM state over model, its conv
tail whole) and whisper-tiny (its cross K/V cache whole); tokens equal,
logits within 1e-5 in fp32 (measured 5.1e-6 at most), but hymba's, held
to its fp64 run (the test says why) and in fp64 within 1e-12, and granite in bf16
within phase 10's 5e-2 (the attention output is summed over two model
ranks in bf16; measured 0.031; as drawn, unsoftened, a rounding flips
which keys win and 0.5 % of the logits part by up to 0.15). Then a JAX
checkpoint (the bf16 run's state after 3 steps) restored onto (2, 2) with
``restore_checkpoint(shardings=)``, every gathered leaf equal and every
block where ``param_shardings`` places it; and ``python -m
torch.distributed.run --nproc-per-node 2 -m repro_torch.launch.train
--smoke --device cpu`` against the one-process run (the same batches;
losses within 3e-2 relative, the checkpoint's parameters within 6 lr; one
checkpoint, written once).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import _mesh_cases as cases
from _jax_port import no_worse

ROOT = Path(__file__).resolve().parents[1]
TIGHT = 1e-4
LR = cases.OPT["peak_lr"]
TRAIN = {"granite": 4, "deepseek": 8}  # ranks


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel-cases")
    out = {}
    for arch, world in TRAIN.items():
        names = [arch + "_fp32", arch + "_bf16"] + (
            ["granite_compressed", "hymba_fp32"] if arch == "granite" else ["deepseekv2_fp32"])
        port_cases = names + (["serve", "grads", "restore"] if arch == "granite" else [])
        out[arch] = (
            cases.start_torch(port_cases, world, tmp / (arch + "-torch"), timeout=420,
                              env={"JAX_CKPT": str(tmp / (arch + "-jax") / "jax-ckpt")}),
            cases.start_jax(names, world, tmp / (arch + "-jax"), timeout=420))
    return out


def _walk(ref, got, prefix=""):
    if isinstance(ref, dict):
        assert sorted(ref) == sorted(got), prefix
        for k in ref:
            yield from _walk(ref[k], got[k], prefix + "/" + k)
    else:
        yield prefix, np.asarray(ref), np.asarray(got)


@pytest.mark.parametrize("arch,case", [("granite", "granite_fp32"),
                                       ("deepseek", "deepseek_fp32"),
                                       ("granite", "granite_compressed"),
                                       ("granite", "hymba_fp32"),
                                       ("deepseek", "deepseekv2_fp32")])
def test_train_steps_match_jax_fp32(runs, arch, case):
    port, ref = (r.results()[case] for r in runs[arch])
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=TIGHT)
    np.testing.assert_allclose(port["grad_norms"], ref["grad_norms"], rtol=TIGHT)
    share = 1e-3 if case.endswith("compressed") else 1e-4
    for name, a, b in _walk(ref["params"], port["params"]):
        d = np.abs(a - b)
        assert (d > TIGHT).sum() <= max(2, d.size * share), (name, int((d > TIGHT).sum()))
        assert d.max() <= 2 * LR, (name, float(d.max()))
    if case.endswith("compressed"):
        return  # an int8 rounding that lands the other way moves m by 0.1 of a step
    for name, a, b in _walk(ref["m"], port["m"]):
        assert np.abs(a - b).max() <= TIGHT * max(np.abs(a).max(), 1e-30), name


@pytest.mark.parametrize("arch", list(TRAIN))
def test_train_step_loss_matches_jax_bf16(runs, arch):
    port, ref = (r.results()[arch + "_bf16"] for r in runs[arch])
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=3e-2)
    assert np.all(np.isfinite(port["grad_norms"]))


@pytest.mark.parametrize("arch", list(TRAIN))
def test_zero1_blocks_follow_the_jax_moment_specs(runs, arch):
    """Each moment block a rank holds is the block of the JAX package's
    ZeRO-1 spec for that leaf (the port's blocks are whole stacked leaves,
    so the layer dim is in the shape)."""
    port, ref = (r.results()[arch + "_fp32"] for r in runs[arch])
    sizes = dict(pod=2, data=2, model=2) if arch == "deepseek" else dict(data=2, model=2)
    shapes = {n: a.shape for n, a, _ in _walk(ref["m"], ref["m"])}
    assert sorted(port["moment_blocks"]) == sorted(n.lstrip("/") for n in shapes)
    for name, spec in ref["moment_specs"].items():
        want = list(shapes["/" + name])
        for d, entry in enumerate(spec):
            for axis in (entry if isinstance(entry, tuple) else (entry,)):
                if axis:
                    want[d] //= sizes[axis]
        assert tuple(port["moment_blocks"][name]) == tuple(want), name


@pytest.mark.parametrize("arch", list(cases.GRADS))
def test_mesh_gradients_match_one_device(runs, arch):
    """Loss and every parameter's gradient of one batch on the mesh (summed
    over data, gathered over model) against one device, fp32, attention
    softened: within 1e-4 of each tensor's largest gradient (sums over
    ranks in another order; measured 2.2e-5 at most, Whisper's cross
    attention), but the key biases, whose gradient is zero in exact
    arithmetic (rounding noise on both sides): within 1e-5 absolute."""
    (loss_1, grads_1), (loss_m, grads_m), names = runs["granite"][0].results()["grads"][arch]
    assert loss_m == pytest.approx(loss_1, rel=1e-6)
    assert len(grads_1) == len(grads_m) == len(names)
    for a, b, name in zip(grads_1, grads_m, names):
        assert a.shape == b.shape, name
        bound = 1e-5 if name == "bk" else 1e-4 * max(np.abs(a).max(), 1e-30)
        assert np.abs(a - b).max() <= bound, name


#: (arch, dtype): the tolerance (rtol = atol) on the decode logits, and the
#: block of the first stack's attention cache each rank holds. hymba-1.5b in
#: fp32 (None) is held to its fp64 run (``test_serve_decode_on_2x2_matches_one_rank``).
SERVE = {("granite-3-2b", "fp32"): (1e-5, {"k": (2, 2, 24, 1, 32)}),
         ("granite-3-2b", "bf16"): (5e-2, {"k": (2, 2, 24, 1, 32)}),
         ("gemma-2b", "fp32"): (1e-5, {"k": (2, 2, 12, 1, 32)}),
         ("deepseek-v2-236b", "fp32"): (1e-5, {"c_kv": (1, 2, 12, 32)}),
         ("deepseek-moe-16b", "fp32"): (1e-5, {"k": (1, 2, 24, 1, 32)}),
         ("hymba-1.5b", "fp32"): (None, {"k": (2, 2, 24, 1, 32)}),
         ("hymba-1.5b", "fp64"): (1e-12, {"k": (2, 2, 24, 1, 32)}),
         ("whisper-tiny", "fp32"): (1e-5, {"k": (2, 2, 24, 1, 32)})}


@pytest.mark.parametrize("arch,dtype", list(SERVE))
def test_serve_decode_on_2x2_matches_one_rank(runs, arch, dtype):
    """Tokens equal, logits within the case's tolerance; hymba-1.5b's fp32
    logits, on the mesh, no further from its fp64 run of the same weights
    than ``NO_WORSE`` times one rank's fp32 logits, in mean and max error.
    hymba's fp32 logits on one rank lie up to 4.8e-5 from fp64 (measured:
    step 5 of 8 amplifies the order of fp32 sums; the mesh's 1.4e-5), so
    the two fp32 runs part by up to 3.3e-5 where the sums are taken in
    another order over model (the row-parallel projections summed over
    two ranks, the SSM's channels split); in fp64 the mesh equals one rank
    within 1e-12 (measured 1.7e-14): the same arithmetic
    (``tools/fp_walk.py --part hymba`` prints these figures)."""
    tol, blocks = SERVE[arch, dtype]
    serve = runs["granite"][0].results()["serve"]
    (tokens_1, logits_1), (tokens_4, logits_4) = serve["%s_%s" % (arch, dtype)]
    assert np.array_equal(tokens_1, tokens_4)
    if tol is None:
        (_, exact), _ = serve["%s_fp64" % arch]
        no_worse(exact, logits_1, logits_4)
    else:
        np.testing.assert_allclose(logits_4, logits_1, rtol=tol, atol=tol)
    # [L, B / data, S (/ model when the KV heads cannot shard), K (/ model), Dh]
    held = serve["%s_%s_cache_block" % (arch, dtype)]
    for name, shape in blocks.items():
        assert tuple(held[name]) == shape, name


def test_jax_checkpoint_restores_onto_2x2(runs):
    restored = runs["granite"][0].results()["restore"]
    ref = runs["granite"][1].results()["granite_bf16"]
    assert int(restored["step"]) == int(restored["opt_step"]) == cases.STEPS["granite-3-2b"]
    for name, a, b in _walk(ref["params"], restored["params"]):
        assert np.array_equal(a, b), name
    for name, a, b in _walk(ref["m"], restored["m"]):
        assert np.array_equal(a, b), name
    assert restored["placed"].all() and bool(restored["restored_in_place"])


def _driver(tmp_path, tag, *launcher):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), TMPDIR=str(tmp_path),
               OMP_NUM_THREADS="1")
    args = [*launcher, "-m", "repro_torch.launch.train", "--smoke", "--device", "cpu",
            "--steps", "3", "--batch", "4", "--seq", "32", "--ckpt-every", "3",
            "--corpus", str(tmp_path / "corpus"), "--ckpt", str(tmp_path / tag)]
    proc = subprocess.run(args, env=env, capture_output=True, text=True, timeout=300,
                          cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


def _losses(stdout):
    return [float(line.split(" loss ")[1].split()[0]) for line in stdout.splitlines()
            if line.startswith("[train] step")]


def test_launch_under_torch_distributed_run(tmp_path):
    one = _driver(tmp_path, "one", sys.executable)
    two = _driver(tmp_path, "two", sys.executable, "-m", "torch.distributed.run", "--standalone",
                  "--nproc-per-node", "2")
    assert two.count("[train] checkpoint @ step 3") == 1  # rank 0 alone logs
    np.testing.assert_allclose(_losses(two), _losses(one), rtol=3e-2)
    assert len(_losses(two)) == 2
    steps = {tag: sorted(p.name for p in (tmp_path / tag).iterdir()) for tag in ("one", "two")}
    assert steps["one"] == steps["two"] == ["step_00000003"]  # no leftover temporary dir
    from repro_torch.checkpoint import latest_checkpoint

    arrays = {}
    for tag in ("one", "two"):
        path = Path(latest_checkpoint(str(tmp_path / tag)))
        import json

        manifest = json.loads((path / "manifest.json").read_text())
        arrays[tag] = {e["key"]: np.load(path / "arrays" / e["file"])
                       for e in manifest["leaves"] if e["kind"] == "array"}
    assert sorted(arrays["one"]) == sorted(arrays["two"])
    for key, a in arrays["one"].items():
        b = arrays["two"][key]
        assert a.shape == b.shape, key
        if key.startswith("params/"):
            assert np.abs(a.astype(np.float64) - b).max() <= 6 * 3e-3, key
        if key.startswith("data/"):
            assert np.array_equal(a, b), key


@pytest.mark.parametrize("arch,variant", [
    ("granite-3-2b", "plain"), ("granite-3-2b", "accum2"), ("granite-3-2b", "compressed"),
    ("deepseek-moe-16b", "plain"), ("xlstm-350m", "plain"), ("whisper-tiny", "plain")])
def test_world_size_1_mesh_step_is_the_one_device_step(arch, variant):
    """On make_host_mesh() of one gloo rank every collective is skipped and
    the step's arithmetic per element is the one-device step's: losses,
    gradient norms and parameters equal bit for bit over 3 steps (what
    phase 12 of chip_smoke.py checks on the card)."""
    import torch

    from repro_torch.configs import all_configs, smoke_config
    from repro_torch.distributed import default_rules
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.models.layers import tree_tensors
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step

    cfg = smoke_config(all_configs()[arch])
    accum, compress = {"plain": (1, False), "accum2": (2, False), "compressed": (1, True)}[variant]
    rng = np.random.default_rng(8)
    batches = []
    for _ in range(3):
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 17), dtype=np.int32)}
        if cfg.family == "audio":
            batch["frames"] = torch.from_numpy(rng.standard_normal(
                (4, cfg.encoder_frames, cfg.d_model), np.float32)).to(cfg.dtype)
        batches.append(batch)
    mesh = make_host_mesh(device="cpu")
    ocfg = AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    runs = []
    for on_mesh in (False, True):
        model = build_model(cfg, device="cpu")
        params, opt = init_train_state(model, torch.Generator().manual_seed(2),
                                       compress_grads=compress)
        kw = dict(grad_accum=accum, compress_grads=compress)
        step = make_train_step(model, mesh, default_rules(mesh), ocfg, **kw)[0] if on_mesh \
            else make_train_step(model, ocfg, **kw)
        metrics = []
        for batch in batches:
            params, opt, m = step(params, opt, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        runs.append((metrics, [t.clone() for t in tree_tensors(params)]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(*(r[1] for r in runs)))
