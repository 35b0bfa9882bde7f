"""Remat in repro_torch (``models.transformer._remat``, ``cfg.remat_policy``)
on the CPU.

The counterpart of the JAX package's ``jax.checkpoint`` policies
(``repro/models/transformer.py:257-275``), applied per layer in train
mode. Remat changes what the forward keeps, never what it computes:

  * granite-3-2b, deepseek-moe-16b and hymba-1.5b at smoke width in fp32:
    the loss and every gradient under ``dots``, ``full`` and
    ``dots_plus_collectives`` bit-equal to ``none``'s;
  * what the forward leaves alive for the backward, counted as the live
    bytes after the forward by the dry-run's counter
    (``launch.dryrun.StepCounter``; ``torch.utils.checkpoint`` keeps its
    tensors under its own saved-tensor hooks, which shadow an outer
    ``saved_tensors_hooks``): ``none`` > ``dots`` > ``full``;
  * the train step with each config's own policy (``dots``; deepseek's
    ``dots_plus_collectives``) against ``repro.train.make_train_step``,
    within ``tests/test_torch_train.py``'s fp32 bounds, every layer run
    under a checkpoint;
  * on 2 gloo ranks at ep = 2 (``tests/_mesh_cases.py``), deepseek-moe-16b's
    backward sends the MoE all-to-alls again under ``dots`` (the recompute
    of dispatch and combine) and not under ``dots_plus_collectives``,
    which keeps their outputs; losses and gradients bit-equal to ``none``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import _mesh_cases as cases
from repro_torch.configs import all_configs, get_config, smoke_config
from repro_torch.launch.dryrun import StepCounter
from repro_torch.models import build_model
from repro_torch.models.layers import tree_tensors

ARCHS = ["granite-3-2b", "deepseek-moe-16b", "hymba-1.5b"]
POLICIES = ["dots", "full", "dots_plus_collectives"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke widths gain nothing from threads; one keeps the other test
    workers' timing as it was."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _model(arch, policy):
    cfg = dataclasses.replace(smoke_config(all_configs()[arch]), dtype=torch.float32,
                              remat_policy=policy)
    model = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    model.requires_grad_(True)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 65), dtype=np.int32))
    return model, {"tokens": tokens}


def _loss_and_grads(arch, policy):
    model, batch = _model(arch, policy)
    loss, _ = model.loss(batch)
    params = tree_tensors(model.param_tree())
    return loss.detach(), torch.autograd.grad(loss, params, allow_unused=True)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_bit_equal_to_none(arch, policy):
    loss, grads = _loss_and_grads(arch, policy)
    ref_loss, ref_grads = _loss_and_grads(arch, "none")
    assert torch.equal(loss, ref_loss)
    assert len(grads) == len(ref_grads)
    for i, (g, r) in enumerate(zip(grads, ref_grads)):
        assert (g is None) == (r is None), i
        assert g is None or torch.equal(g, r), i


def _kept_bytes(arch, policy):
    model, batch = _model(arch, policy)
    with StepCounter() as counter:
        counter.hold(tree_tensors(model.param_tree()))
        before = counter.live
        loss, _ = model.loss(batch)
        kept = counter.live - before
    del loss
    return kept


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_keeps_less_for_the_backward(arch):
    kept = {p: _kept_bytes(arch, p) for p in ("none", "dots", "full")}
    assert kept["none"] > kept["dots"] > kept["full"] > 0, kept


@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-moe-16b"])
def test_step_with_the_config_policy_matches_jax(arch, monkeypatch):
    """tests/test_torch_train.py's fp32 comparison, with the config's own
    policy and every layer counted through ``checkpoint``."""
    import torch.utils.checkpoint as tuc

    from test_torch_train import OPT, STEPS, TIGHT, _both_trained, _leaves_by_path, f32
    from repro_torch.models.convert import params_to_jax

    calls = []
    real = tuc.checkpoint
    monkeypatch.setattr(tuc, "checkpoint", lambda *a, **k: calls.append(1) or real(*a, **k))
    params, model, rows, _ = _both_trained(arch, "fp32", "plain", soften=True)
    assert model.cfg.remat_policy == get_config(arch).remat_policy != "none"
    assert len(calls) == model.cfg.n_layers * STEPS
    for i, (m, tm) in enumerate(rows):
        assert float(tm["loss"]) == pytest.approx(float(m["loss"]), rel=TIGHT), i
        assert float(tm["grad_norm"]) == pytest.approx(float(m["grad_norm"]), rel=TIGHT), i
    lr = OPT["peak_lr"]
    for name, a, b in _leaves_by_path(params, params_to_jax(model)):
        d = np.abs(f32(a) - f32(b))
        if name.endswith("/bk"):
            assert d.max() <= 3 * lr, name
            continue
        assert (d > TIGHT).sum() <= max(2, d.size * 1e-4), name
        assert d.max() <= 2 * lr, (name, float(d.max()))


@pytest.fixture(scope="module")
def a2a(tmp_path_factory):
    run = cases.start_torch(["remat_a2a"], 2, tmp_path_factory.mktemp("remat-a2a"), timeout=300)
    return run.results()["remat_a2a"]


def test_moe_backward_repeats_all_to_alls_only_under_dots(a2a):
    layers = int(a2a["moe_layers"])
    # forward: dispatch (tokens, expert ids) and combine; backward: the
    # gradients of the two float ones
    assert list(a2a["none"]) == [3 * layers, 2 * layers]
    assert list(a2a["dots"]) == [3 * layers, 5 * layers]  # the forward's three again
    assert list(a2a["dots_plus_collectives"]) == [3 * layers, 2 * layers]


@pytest.mark.parametrize("policy", ["dots", "dots_plus_collectives"])
def test_moe_remat_on_two_ranks_bit_equal_to_none(a2a, policy):
    assert np.array_equal(a2a[policy + "_loss"], a2a["none_loss"])
    for g, r in zip(a2a[policy + "_grads"], a2a["none_grads"]):
        assert np.array_equal(g, r)
