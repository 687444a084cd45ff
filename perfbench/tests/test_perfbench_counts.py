"""The operation and byte counts against hand counts at tiny shapes."""

import pytest

from pbcore import counts as C


def test_causal_pairs_and_bound():
    assert C.causal_pairs(3, 3) == 1 + 2 + 3
    assert C.causal_pairs(4, 2) == 1 + 2 + 2 + 2
    t, which = C.bound(3.35e12, 1.0)
    assert which == "bytes" and t == pytest.approx(1.0)
    t, which = C.bound(1.0, 989e12)
    assert which == "operations" and t == pytest.approx(1.0)


def test_vit_flops_by_hand():
    c = {"hidden_size": 4, "patch_size": 2, "intermediate_size": 8, "image_size": 4}
    n, T, d = 4, 5, 4                     # 2 x 2 patches and the class token
    patch = 2 * n * 3 * 2 * 2 * d
    block = 4 * 2 * T * d * d + 2 * 2 * T * d * 8 + 2 * 2 * T * T * d
    assert C.vit_flops(c, 3) == patch + 3 * block


def test_decoder_flops_by_hand():
    L = {"hidden_size": 8, "head_dim": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
         "intermediate_size": 16, "num_hidden_layers": 2}
    T, rows = 3, 2
    proj = 2 * T * 8 * 8 + 2 * 2 * T * 8 * 4 + 2 * T * 8 * 8          # q; k, v at 2 heads; o
    mlp = 3 * 2 * T * 8 * 16
    attn = 2 * 2 * (1 + 2 + 3) * 4 * 2
    assert C.decoder_flops(L, rows, T) == rows * 2 * (proj + mlp + attn)
    assert C.llm_attention_bytes(L, rows, T) == 2 * rows * T * 2 * (4 + 4 + 2 + 2)


def test_sam_encoder_flops_by_hand():
    e = {"embed_dim": 2, "patch_size": 1, "window_size": 2, "image_size": 3, "depth": 2,
         "global_attn_indexes": [1], "mlp_ratio": 2.0, "out_chans": 1}
    # grid 3: windowed block on 4 x 4 padded tokens in 4 windows of 4
    win = 8 * 16 * 4 + 4 * (4 * 4 * 4) * 2 + 4 * 16 * 2 * 2
    glob = 8 * 9 * 4 + 4 * 81 * 2 + 4 * 9 * 3 * 2
    mlp = 4 * 9 * 2 * 4
    patch = 2 * 9 * 3 * 2
    neck = 2 * 9 * 2 * 1 + 18 * 9
    assert C.sam_encoder_flops(e) == patch + win + glob + 2 * mlp + neck


def test_twoway_flops_shared_base_counts_layer0_keys_once():
    dc = {"transformer_dim": 8, "attention_downsample_rate": 2, "transformer_mlp_dim": 16,
          "transformer_depth": 1, "num_multimask_outputs": 3, "iou_head_depth": 3,
          "iou_head_hidden_dim": 8}
    shared = C.twoway_flops(dc, 2, 3, 4, True, False)
    own = C.twoway_flops(dc, 2, 3, 4, False, False)
    assert own - shared == 3 * 2.0 * (2 * 4 - 4) * 8 * 4
    assert C.twoway_flops(dc, 2, 3, 4, True, True) > shared
