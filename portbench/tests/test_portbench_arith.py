"""The frozen arithmetic against hand counts at small shapes."""

from portbench import arith

TINY = {"num_hidden_layers": 2, "hidden_size": 8, "num_attention_heads": 2,
        "num_key_value_heads": 1, "intermediate_size": 16, "vocab_size": 10,
        "tie_word_embeddings": True}


def test_stage2_launch_bytes():
    # 2 tiles of 8192 uint16 symbols in, a byte each out, 3 tables, a tile id each
    assert arith.stage2_launch_bytes(("replace", 2, 3)) == 2 * 8192 * 3 + 3 * 33024 + 2 * 4
    # 1 batch of 1024 lanes of 64 bytes, a 4-byte CRC each
    assert arith.stage2_launch_bytes(("crc", 1, 64), 5) == 5 * (1024 * 64 + 1024 * 4)
    assert arith.stage2_bytes({("replace", 1, 1): 2, ("crc", 2, 8): 1}) == \
        2 * (8192 * 3 + 33024 + 4) + 2 * 1024 * 8 + 2 * 1024 * 4


def test_param_count_by_hand():
    # per layer: q 8x8, k 8x4, v 8x4, o 8x8, MLP 3 x 8x16, norms 2 x 8
    per_layer = 64 + 32 + 32 + 64 + 384 + 16
    assert arith.param_count(TINY) == 10 * 8 + 2 * per_layer + 8
    assert arith.param_count(dict(TINY, tie_word_embeddings=False)) == \
        10 * 8 + 2 * per_layer + 8 + 80


def test_granite_parameters_as_published():
    from portbench import harness

    cfg = harness.Manifest().config("granite-3-2b")
    assert arith.param_count(cfg) == cfg["parameters"] == 2533531648


def test_train_flops_per_token_by_hand():
    n = arith.param_count(TINY)
    # 6N, plus 12 L H Dh T: 12 * 2 * 2 * 4 * 32
    assert arith.train_flops_per_token(TINY, 32) == 6 * n + 12 * 2 * 2 * 4 * 32


def test_decode_step_by_hand():
    weights = 2 * (64 + 32 + 32 + 64 + 384) + 8 * 10
    # batch 3, new token at position 4: 5 keys; 4 H Dh a key a layer
    assert arith.decode_step_flops(TINY, 3, 4) == 3 * (2 * weights + 4 * 2 * 2 * 4 * 5)
    kv_token = 2 * 2 * 1 * 4 * 2  # layers x (k, v) x heads x Dh x bf16
    want = arith.param_count(TINY) * 2 + 3 * 5 * kv_token + 3 * kv_token + 3 * 10 * 2
    assert arith.decode_step_bytes(TINY, 3, 4) == want
    assert arith.decode_step_least_s(TINY, 3, 4) == max(
        arith.decode_step_flops(TINY, 3, 4) / 989e12, want / 3.35e12)
