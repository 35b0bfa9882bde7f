"""repro_torch's mesh, sharding rules and collectives against the JAX package.

The spec functions (``ShardingRules.spec``, ``fit_spec``, ``zero1_spec``,
``batch_partition``, ``param_shardings``, ``opt_state_shardings``,
``cache_shardings``) are pure arithmetic on axis sizes: they are held to
the JAX package's for every parameter and cache leaf of the ten configs at
published width on meshes (1, 1), (2, 2), (2, 2, 2), (16, 16) and
(2, 16, 16), the JAX side on ``jax.sharding.AbstractMesh`` (no devices).

Then the collectives on 4 gloo ranks against the JAX package on 4 forced
host devices, from one numpy seed (``tests/_mesh_cases.py``):
``pipeline_apply`` with 4 stages and 8 microbatches (against the JAX
package and the sequential loop at 1e-5, the reference's own bound),
``compressed_psum`` (bit for bit: the same scale, integers and products),
``sharded_embed_lookup`` on (1, 4) (bit for bit: one nonzero term per
sum) and ``moe_layer`` on (2, 2), ep = tp = 2, fp32: its output, aux loss
and input gradient at 1e-5 (sums in another order), at a capacity factor
that drops nothing and at one that drops pairs (the same pairs on both
sides: capacity depends on the mesh, which is the same).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import _mesh_cases as cases
from repro.configs import all_configs as jax_configs
from repro.distributed import sharding as jshard
from repro.models import build_model as jax_build
from repro.serve.serve_step import cache_shardings as jax_cache_shardings
from repro.train import train_step as jstep
from repro_torch.configs import all_configs
from repro_torch.distributed import sharding as tshard
from repro_torch.launch import mesh as tmesh
from repro_torch.models import build_model
from repro_torch.serve.serve_step import cache_shardings
from repro_torch.train import train_step as tstep

MESHES = {"1x1": ((1, 1), ("data", "model")), "2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
ARCHS = sorted(jax_configs())
TOL = 1e-5


def _meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), dict(zip(axes, shape))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    elif isinstance(tree, tuple) and not isinstance(tree, tshard.P):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _jax_leaves(tree):
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        yield "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path), leaf


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax(arch, mesh):
    """spec, fit_spec and zero1_spec of every parameter leaf."""
    jmesh, tmesh_ = _meshes(mesh)
    jrules, trules = jshard.default_rules(jmesh), tshard.default_rules(tmesh_)
    assert trules.rules == jrules.rules
    jdefs = dict(_leaves(jax_build(jax_configs()[arch]).defs))
    tdefs = dict(_leaves(build_model(all_configs()[arch], device="meta").defs))
    assert sorted(jdefs) == sorted(tdefs)
    for name, d in tdefs.items():
        jd = jdefs[name]
        spec = trules.spec(d.logical)
        assert tuple(spec) == tuple(jrules.spec(jd.logical)), name
        fit = tshard.fit_spec(spec, d.shape, tmesh_)
        jfit = jshard.fit_spec(jrules.spec(jd.logical), jd.shape, jmesh)
        assert tuple(fit) == tuple(jfit), name
        assert tuple(tshard.zero1_spec(fit, d.shape, tmesh_)) == \
            tuple(jshard.zero1_spec(jfit, jd.shape, jmesh)), name
    for n in (1, 2, 3, 4, 8, 16, 32, 48, 512):
        assert tuple(tshard.batch_partition(tmesh_, n)) == \
            tuple(jshard.batch_partition(jmesh, n)), n
    assert tshard.mesh_device_count(tmesh_) == jshard.mesh_device_count(jmesh)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shardings_match_jax(arch, mesh):
    """The spec of every decode-cache leaf (32 sequences of 1 024; the
    sequence-sharded K/V where the KV heads cannot shard over model)."""
    jmesh, tmesh_ = _meshes(mesh)
    jcfg, cfg = jax_configs()[arch], all_configs()[arch]
    jm = jax_build(jcfg)
    jcaches = jax.eval_shape(lambda: jm.init_decode_caches(32, 1024))
    want = {k: tuple(v.spec) for k, v in _jax_leaves(jax_cache_shardings(jcfg, jmesh, jcaches))}
    caches = build_model(cfg, device="meta").init_decode_caches(32, 1024, device="meta")
    got = {k: tuple(v.spec) for k, v in _leaves(cache_shardings(cfg, tmesh_, caches))}
    assert got == want


@pytest.mark.parametrize("mesh", ["2x2", "2x2x2", "16x16"])
@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-moe-16b"])
def test_param_and_opt_shardings_match_jax(arch, mesh):
    """param_shardings and opt_state_shardings (ZeRO-1 moments, the step
    replicated) place every leaf as the JAX package's do."""
    jmesh, tmesh_ = _meshes(mesh)
    jm = jax_build(jax_configs()[arch])
    model = build_model(all_configs()[arch], device="meta")
    jp = dict(_jax_leaves(jstep.param_shardings(jm, jmesh, jshard.default_rules(jmesh))))
    tp = dict(_leaves(tstep.param_shardings(model, tmesh_, tshard.default_rules(tmesh_))))
    assert {k: tuple(v.spec) for k, v in tp.items()} == {k: tuple(v.spec) for k, v in jp.items()}
    jo = jstep.opt_state_shardings(jm, jmesh, jshard.default_rules(jmesh))
    to = tstep.opt_state_shardings(model, tmesh_, tshard.default_rules(tmesh_))
    assert tuple(to["step"].spec) == tuple(jo["step"].spec) == ()
    for key in ("m", "v"):
        assert {k: tuple(v.spec) for k, v in _leaves(to[key])} == \
            {k: tuple(v.spec) for k, v in _jax_leaves(jo[key])}
    assert tstep.batch_shardings(tmesh_, tshard.default_rules(tmesh_),
                                 {"tokens": np.zeros((64, 9))})["tokens"].spec == \
        tuple(jstep.batch_shardings(jmesh, jshard.default_rules(jmesh),
                                    {"tokens": np.zeros((64, 9))})["tokens"].spec)


def test_placements_and_blocks():
    """A spec as DTensor placements, and a block's shape, on (2, 16, 16)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = dict(zip(*reversed(MESHES["2x16x16"])))
    rules = tshard.default_rules(mesh)
    assert rules.placements(mesh, ("batch", None, "vocab")) == (Shard(0), Shard(0), Shard(2))
    assert rules.placements(mesh, ("embed", "ffn")) == (Replicate(), Replicate(), Shard(1))
    sh = tshard.NamedSharding(mesh, tshard.P(("model", "data"), None))
    assert sh.local_shape((49152, 2048)) == (192, 2048)
    assert sh.layer(0) == sh and sh.layer(1).spec == (None,)
    assert rules.with_overrides(vocab=None).spec(("vocab", "embed")) == (None, None)


# ---------------------------------------------------------------------------
# meshes in this process
# ---------------------------------------------------------------------------

def test_meshes_on_one_rank():
    """make_host_mesh is (world, 1) over (data, model) on a group it starts
    itself (gloo on the host, a file store); make_production_mesh needs 256
    or 512 ranks and says so; a mesh on the card raises without one."""
    host = tmesh.make_host_mesh(device="cpu")
    assert host.mesh_dim_names == ("data", "model") and tuple(host.shape) == (1, 1)
    assert torch.distributed.get_backend() == "gloo"
    assert tuple(tmesh.make_mesh((1, 1, 1), ("pod", "data", "model"), device="cpu").shape) == \
        (1, 1, 1)
    for multi, n in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match="needs %d ranks" % n):
            tmesh.make_production_mesh(multi_pod=multi, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            tmesh.make_mesh((1, 1), ("data", "model"), device="cuda")


def test_constrain_redistributes_a_dtensor_only():
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = tmesh.make_host_mesh(device="cpu")
    rules = tshard.default_rules(mesh)
    x = torch.arange(12.0).reshape(4, 3)
    assert tshard.constrain(x, rules, "batch", None) is x
    d = distribute_tensor(x, mesh, (Replicate(), Replicate()))
    out = tshard.constrain(d, rules, "batch", "vocab")
    assert tuple(out.placements) == (Shard(0), Shard(1))
    assert torch.equal(out.full_tensor(), x)


# ---------------------------------------------------------------------------
# collectives on 4 gloo ranks against the JAX package on 4 host devices
# ---------------------------------------------------------------------------

CASES = ["pipeline", "psum", "embed", "moe_8.0", "moe_1.0"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh-cases")
    port = cases.start_torch(CASES, 4, tmp / "torch", timeout=300)
    ref = cases.start_jax(CASES, 4, tmp / "jax", timeout=300)
    return port, ref


def test_pipeline_apply_matches_jax_and_the_sequential_loop(ranks):
    port, ref = (r.results()["pipeline"] for r in ranks)
    np.testing.assert_allclose(port["out"], ref["out"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(port["out"], port["sequential"], rtol=TOL, atol=TOL)


def test_compressed_psum_matches_jax(ranks):
    port, ref = (r.results()["psum"] for r in ranks)
    assert port["out"].dtype == np.float32
    assert np.array_equal(port["out"], ref["out"])
    x = cases.psum_inputs()
    scale = np.float32(np.abs(x).max() / np.float32(127))
    np.testing.assert_allclose(port["out"], x.sum(0), atol=4 * 0.5 * scale)


def test_sharded_embed_lookup_matches_jax(ranks):
    port, ref = (r.results()["embed"] for r in ranks)
    assert port["local_rows"] == 512 // 4
    assert np.array_equal(port["out"], ref["out"])


@pytest.mark.parametrize("cf", ["8.0", "1.0"])
def test_moe_layer_on_2x2_matches_jax(ranks, cf):
    port, ref = (r.results()["moe_" + cf] for r in ranks)
    assert port["local_experts"] == 8 // 2
    for key in ("y", "dx"):
        scale = np.abs(ref[key]).max()
        np.testing.assert_allclose(port[key], ref[key], rtol=TOL, atol=TOL * scale, err_msg=key)
    np.testing.assert_allclose(port["aux"], ref["aux"], rtol=1e-6)
    if cf == "1.0":  # pairs were dropped, the same on both sides
        full = ranks[1].results()["moe_8.0"]["y"]
        assert np.abs(ref["y"] - full).max() > 1e-2


def test_ranks_left_no_process(ranks):
    for launch in ranks:
        launch.results()
        assert all(p.poll() == 0 for p in launch.procs)
