"""Tensor parallelism of the xLSTM forms, a sliding-window ring cache split
over ``model``, and a rank's own KV heads, on gloo ranks on the CPU.

From one numpy seed (``tests/_mesh_cases.py``; one launch of the port on
4 gloo ranks, one of the JAX package on 4 forced host devices):

  * xlstm-350m at smoke width (4 blocks in 2 groups, d_model 128, 4 heads)
    on (data, model) = (2, 2), its ``ssm_inner`` leaves over model, against
    the JAX package's train step, 3 steps in fp32: losses and gradient
    norms within 1e-4 relative, every gathered parameter element within
    1e-4 but at most max(2, 1e-4 of a leaf) elements within 2 lr, the
    moments within 1e-4 of their leaf's largest (``test_torch_parallel.py``'s
    bounds), and the ZeRO-1 blocks each rank holds shaped as the JAX
    package's moment specs give them;
  * the xLSTM's loss and every gradient of one fp32 batch on (2, 2) and on
    (1, 4) against one device (its training mLSTM cell on a rank's heads;
    with 2 heads on (1, 4), on one head and half its value columns), and
    granite-3-2b's and qwen2.5-32b's (K/V biases) on (1, 4), where their 2
    KV heads do not divide model and each rank projects only the KV head
    its query head reads (granite's products with ``wk`` and with ``wv``
    one head wide):
    the loss within 1e-6 relative, each gradient within 1e-4 of its
    tensor's largest; the same for weights every rank holds whole, where
    each rank computes a quarter of the weight's gradient and the quarters
    are gathered (``transformer.wgrad_split``): gemma-2b with 5 query heads
    (its one KV head) and whisper-tiny with 5 and 5 (self, cross and
    encoder attention), both with a vocabulary of 514, and deepseek-v2's
    MLA down projections (no experts); their FLOPs on the mesh fall by
    3/4 of those weights' gradient products against the same step with the
    split off;
  * greedy decode through ``make_serve_steps(model, mesh, rules, ...)``
    against the one-device serve steps, prompt 48, max_len 96, 40 steps:
    the xLSTM on (2, 2), its ``c`` and ``n`` split on ``Dk``, and with 2
    heads on (1, 4) (the prefill's cell a head and half its value columns
    a rank, its final state gathered and cut to the rank's ``Dk`` rows);
    hymba-1.5b on (1, 4), its 64-slot ring split 16 a rank and wrapping, once as drawn
    (4 heads split, 2 KV heads whole) and once with 5 heads and 5 KV heads
    (both whole; ``head_dim`` 32). Tokens equal; in fp64 the logits agree
    to 1e-12 (the same arithmetic up to summation order); in fp32 within
    1e-5 of the run's largest logit (measured 1.12e-5 absolute against
    logits up to 4.72, at every step alike, so the rounding does not grow
    with the steps; 8 steps of ``test_torch_parallel.py`` stay within
    5.1e-6 absolute).
"""

import numpy as np
import pytest

import _mesh_cases as cases
from test_torch_parallel import LR, TIGHT, _walk

SIZES = dict(data=2, model=2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp-forms")
    port = cases.start_torch(["xlstm_fp32", "tp_grads", "tp_serve"], 4, tmp / "torch",
                             timeout=420)
    ref = cases.start_jax(["xlstm_fp32"], 4, tmp / "jax", timeout=420)
    return port, ref


def test_xlstm_train_steps_on_2x2_match_jax_fp32(runs):
    port, ref = (r.results()["xlstm_fp32"] for r in runs)
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=TIGHT)
    np.testing.assert_allclose(port["grad_norms"], ref["grad_norms"], rtol=TIGHT)
    for name, a, b in _walk(ref["params"], port["params"]):
        d = np.abs(a - b)
        assert (d > TIGHT).sum() <= max(2, d.size * 1e-4), (name, int((d > TIGHT).sum()))
        assert d.max() <= 2 * LR, (name, float(d.max()))
    for name, a, b in _walk(ref["m"], port["m"]):
        assert np.abs(a - b).max() <= TIGHT * max(np.abs(a).max(), 1e-30), name


def test_xlstm_zero1_blocks_follow_the_jax_moment_specs(runs):
    port, ref = (r.results()["xlstm_fp32"] for r in runs)
    shapes = {n: a.shape for n, a, _ in _walk(ref["m"], ref["m"])}
    assert sorted(port["moment_blocks"]) == sorted(n.lstrip("/") for n in shapes)
    split = 0
    for name, spec in ref["moment_specs"].items():
        want = list(shapes["/" + name])
        for d, entry in enumerate(spec):
            for axis in (entry if isinstance(entry, tuple) else (entry,)):
                if axis:
                    want[d] //= SIZES[axis]
                    split += axis == "model"
        assert tuple(port["moment_blocks"][name]) == tuple(want), name
    assert split >= 7  # embed, unembed, w_up, w_qkv, w_if, out_norm, w_down, w_gates...


@pytest.mark.parametrize("key", ["%s@%dx%d" % ((tag,) + shape)
                                 for tag, _, shape, _ in cases.TP_GRADS])
def test_tp_gradients_match_one_device(runs, key):
    (loss_1, grads_1), (loss_m, grads_m), names = runs[0].results()["tp_grads"][key]
    assert loss_m == pytest.approx(loss_1, rel=1e-6)
    assert len(grads_1) == len(grads_m) == len(names)
    for a, b, name in zip(grads_1, grads_m, names):
        assert a.shape == b.shape, name
        bound = 1e-5 if name == "bk" else 1e-4 * max(np.abs(a).max(), 1e-30)
        assert np.abs(a - b).max() <= bound, name


def _whole_weight_elements(tag):
    """(tokens a rank's products see, the elements of the weights every
    rank holds whole whose gradients ``wgrad_split`` splits) of a
    ``cases.TP_SPLIT`` case on (1, 4)."""
    _, arch, _, replaced = next(c for c in cases.TP_GRADS if c[0] == tag)
    cfg = cases._torch_cfg(arch, "fp32", **replaced)
    d, tokens = cfg.d_model, 4 * 32  # every row on each rank: data is 1
    attn = 2 * d * cfg.n_heads * cfg.resolved_head_dim + \
        2 * d * cfg.n_kv_heads * cfg.resolved_head_dim  # wq, wo; wk, wv
    vocab = cfg.vocab_size * d
    if cfg.use_mla:  # the down projections of the latents
        return tokens, cfg.n_layers * d * (cfg.q_lora_rank + cfg.kv_lora_rank
                                           + cfg.qk_rope_head_dim) + vocab
    if cfg.encoder_layers:  # encoder self, decoder self and cross (encoder frames 4 x 32)
        assert cfg.encoder_frames * 4 == tokens
        return tokens, (cfg.encoder_layers + 2 * cfg.n_layers) * attn + vocab
    return tokens, cfg.n_layers * attn + vocab


@pytest.mark.parametrize("tag", cases.TP_SPLIT)
def test_whole_weight_gradients_split_over_model(runs, tag):
    """On (1, 4) each rank computes the gradient of a weight it holds whole
    for a quarter of one of its dims: 3/4 of each such product
    (2 x tokens x the weight's elements) goes."""
    flops = runs[0].results()["tp_grads"]["%s@1x4/flops" % tag]
    tokens, elements = _whole_weight_elements(tag)
    assert flops["whole"] - flops["split"] == 3 * 2 * tokens * elements // 4


def test_granite_projects_one_kv_head_a_rank(runs):
    """granite-3-2b at smoke width: 4 query heads and 2 KV heads of 32 on
    model = 4, so a rank's query head reads one KV head, and its products
    with ``wk`` and ``wv`` are one head wide (32 columns, not 64)."""
    products = runs[0].results()["tp_grads"]["granite-3-2b@1x4/products"]
    assert sorted(products) == ["wk", "wv"]
    for name, shapes in products.items():
        assert len(shapes) >= 1, name
        assert all(s[-1] == 32 for s in shapes), (name, shapes)


#: tag: the block of the serve caches each rank holds (xLSTM: the mLSTM
#: states [G, n_m, B / data, H, Dk / model, Dv]; hymba: the first stack's
#: ring [L, B, W / model, K, Dh], its ``pos`` [L, W] whole).
SERVE = {"xlstm-350m": {"c": (2, 1, 2, 4, 32, 64), "n": (2, 1, 2, 4, 32), "m": (2, 1, 2, 4)},
         "xlstm-350m-2heads": {"c": (2, 1, 4, 2, 32, 128), "n": (2, 1, 4, 2, 32),
                               "m": (2, 1, 4, 2)},
         "hymba-1.5b": {"k": (2, 4, 16, 2, 32), "v": (2, 4, 16, 2, 32), "pos": (2, 64)},
         "hymba-1.5b-5heads": {"k": (2, 4, 16, 5, 32), "pos": (2, 64)}}


@pytest.mark.parametrize("dtype", ["fp32", "fp64"])
@pytest.mark.parametrize("tag", list(SERVE))
def test_serve_decode_matches_one_rank(runs, tag, dtype):
    serve = runs[0].results()["tp_serve"]
    (tokens_1, logits_1), (tokens_m, logits_m) = serve["%s_%s" % (tag, dtype)]
    assert tokens_1.shape == (4, cases.TP_NEW)
    assert np.array_equal(tokens_1, tokens_m)
    bound = 1e-12 if dtype == "fp64" else 1e-5 * np.abs(logits_1).max()
    assert np.abs(logits_m - logits_1).max() <= bound
    held = serve["%s_%s_cache_block" % (tag, dtype)]
    for name, shape in SERVE[tag].items():
        assert tuple(held[name]) == shape, name
