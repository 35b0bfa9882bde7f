"""The references at tiny sizes: the packing, the gzip judge and its
control, and the decoder against a naive one written from its equations."""

import math

import numpy as np
import pytest
import torch

from portbench import inputs
from portbench.reference import granite, gzip_bytes, tokens

TINY = {"num_hidden_layers": 2, "hidden_size": 32, "num_attention_heads": 4,
        "num_key_value_heads": 2, "intermediate_size": 64, "vocab_size": 300,
        "tie_word_embeddings": True, "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
        "initializer_range": 0.02}


def test_batches_pack_shards_in_turn():
    got = tokens.batches([b"ab", b"c"], batch=2, seq_len=2, count=2)
    stream = [257, 97, 98, 257, 99] * 3
    assert got.tolist() == np.array(stream[:12]).reshape(2, 2, 3).tolist()


def test_gzip_judge_and_control():
    text = inputs.base64_text(inputs.stream(5, "t"), 20000)
    assert text.count(b"\n") == 20000 // 77
    archive = inputs.gzip_member(text, 6)
    assert gzip_bytes.mismatched_bytes(text, 100, text[100:200], 100) == 0
    assert gzip_bytes.mismatched_bytes(text, 100, text[101:201], 100) > 0
    assert gzip_bytes.mismatched_bytes(text, 0, text[:50], 100) == 50
    broken = gzip_bytes.control_decompress(archive, len(archive) // 3)
    assert gzip_bytes.mismatched_bytes(text, 0, broken, len(text)) > 0


def naive_logits(cfg, W, toks):
    """The decoder's equations position by position, in fp64."""
    L, D, H, K = (cfg[k] for k in ("num_hidden_layers", "hidden_size", "num_attention_heads",
                                  "num_key_value_heads"))
    Dh = D // H
    w = {k: v.double() for k, v in W.items()}

    def rms(x, g):
        return x / torch.sqrt((x * x).mean(-1, keepdim=True) + 1e-6) * (1 + g)

    def rope(x, p):
        half = Dh // 2
        f = torch.tensor([10000.0 ** (-2 * i / Dh) for i in range(half)], dtype=torch.float64)
        a = p * f
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * torch.cos(a) - x2 * torch.sin(a),
                          x2 * torch.cos(a) + x1 * torch.sin(a)], -1)

    S = toks.shape[0]
    x = w["embed"][toks]
    for i in range(L):
        h = rms(x, w["norm1"][i])
        q = torch.einsum("sd,dhk->shk", h, w["wq"][i])
        k = torch.einsum("sd,dhk->shk", h, w["wk"][i])
        v = torch.einsum("sd,dhk->shk", h, w["wv"][i])
        pos = torch.arange(S, dtype=torch.float64)[:, None, None]
        q, k = rope(q, pos), rope(k, pos)
        out = torch.zeros(S, H, Dh, dtype=torch.float64)
        for t in range(S):
            for hh in range(H):
                kv = hh // (H // K)
                s = (k[: t + 1, kv] @ q[t, hh]) / math.sqrt(Dh)
                out[t, hh] = torch.softmax(s, 0) @ v[: t + 1, kv]
        x = x + torch.einsum("shk,hkd->sd", out, w["wo"][i])
        h2 = rms(x, w["norm2"][i])
        g = h2 @ w["w_gate"][i]
        x = x + (g * torch.sigmoid(g) * (h2 @ w["w_up"][i])) @ w["w_down"][i]
    return rms(x, w["final_norm"]) @ w["embed"].t()


def test_decoder_logits_against_its_equations(monkeypatch):
    monkeypatch.setattr(granite, "Q_CHUNK", 4)  # several query blocks
    W = inputs.decoder_weights(TINY, 3, "cpu")
    W = {k: (v.float() * 20).to(torch.bfloat16) for k, v in W.items()}  # unit-scale weights
    toks = torch.randint(0, 300, (2, 11), generator=torch.Generator().manual_seed(0))
    got = granite.Decoder(TINY, W).logits(toks).double()
    for b in range(2):
        want = naive_logits(TINY, W, toks[b])
        assert (got[b] - want).abs().max() < 0.05 * want.abs().max()


def test_fp8_control_departs_from_bf16():
    W = inputs.decoder_weights(TINY, 3, "cpu")
    toks = torch.randint(0, 300, (1, 16), generator=torch.Generator().manual_seed(1))
    a = granite.Decoder(TINY, W, "bf16").logits(toks).float()
    b = granite.Decoder(TINY, W, "fp8").logits(toks).float()
    assert (a - b).abs().max() > 0


def test_train_moves_every_leaf_and_reports_norms():
    W = inputs.decoder_weights(TINY, 4, "cpu")
    batches = [torch.randint(0, 259, (2, 9), generator=torch.Generator().manual_seed(s))
               for s in range(2)]
    opt = {"peak_lr": 3e-4, "warmup_steps": 0, "total_steps": 100, "end_lr_fraction": 0.1,
           "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1, "clip_norm": 1.0,
           "no_decay": ["final_norm"], "z_loss": 1e-4}
    out = granite.train(granite.Decoder(TINY, W), batches, opt)
    assert len(out["losses"]) == 2 and all(math.isfinite(x) for x in out["losses"])
    assert set(out["grad_norms"]) == set(out["change_norms"])
    assert len(out["grad_norms"]) == 2 + 9 * 2
    assert all(v > 0 for v in out["change_norms"].values())


def test_lr_schedule():
    opt = {"peak_lr": 1.0, "warmup_steps": 10, "total_steps": 110, "end_lr_fraction": 0.1}
    assert granite.lr_at(opt, 5) == pytest.approx(0.5)
    assert granite.lr_at(opt, 10) == pytest.approx(1.0)
    assert granite.lr_at(opt, 110) == pytest.approx(0.1)
