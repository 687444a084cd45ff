"""Operations and bytes from the configuration's shapes, and the card's
peaks.  The counts take the work as the model defines it, each input byte
read once and each output byte written once, and no recomputation.

``bound``, ``causal_pairs`` and ``twoway_flops`` are frozen copies of
``chip_smoke.py``'s (``bound`` :371, ``causal_pairs`` :387,
``twoway_flops`` :1745), the last taking its widths from the
configuration document instead of the decoder module.
"""

from __future__ import annotations

from typing import Dict, Tuple

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAKS = {"bf16_flop_per_s": 989e12, "int8_op_per_s": 1979e12, "hbm_bytes_per_s": 3.35e12}
BF16 = 2


def bound(nbytes: float, flops: float, peak: float = PEAKS["bf16_flop_per_s"]) -> Tuple[float, str]:
    """The least time in seconds for ``flops`` operations and ``nbytes``
    bytes of device memory traffic, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / PEAKS["hbm_bytes_per_s"], flops / peak
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def causal_pairs(T: int, S: int) -> int:
    return sum(min(i + 1, S) for i in range(T))


def attention_flops(pairs: float, heads: int, head_dim: int) -> float:
    """QK^T and PV over ``pairs`` (query, key) pairs."""
    return 4.0 * pairs * heads * head_dim


# ---------------------------------------------------------------------------
# LLM-Seg predict
# ---------------------------------------------------------------------------


def vit_flops(c: Dict, n_blocks: int) -> float:
    """One image through a ViT tower's patch embedding and ``n_blocks``."""
    d, p, I = c["hidden_size"], c["patch_size"], c["intermediate_size"]
    n = (c["image_size"] // p) ** 2
    T = n + 1
    f = 2.0 * n * 3 * p * p * d
    f += n_blocks * (8.0 * T * d * d + 4.0 * T * d * I + attention_flops(T * T, 1, d))
    return f


def decoder_flops(L: Dict, rows: int, T: int) -> float:
    """``rows`` causal sequences of T tokens through the decoder's layers."""
    d, hd, H, Hkv, I = (L["hidden_size"], L["head_dim"], L["num_attention_heads"],
                        L["num_key_value_heads"], L["intermediate_size"])
    per_tok = 2.0 * d * hd * (2 * H + 2 * Hkv) + 6.0 * d * I
    attn = attention_flops(causal_pairs(T, T), H, hd)
    return rows * L["num_hidden_layers"] * (T * per_tok + attn)


def llm_attention_bytes(L: Dict, rows: int, T: int) -> float:
    """One layer's causal attention: q and o at the query heads, k and v at
    the key-value heads, bf16."""
    hd, H, Hkv = L["head_dim"], L["num_attention_heads"], L["num_key_value_heads"]
    return BF16 * rows * T * hd * (2 * H + 2 * Hkv)


def select_flops(s: Dict, llm_dim: int, rows: int, K: int) -> float:
    sd, mlp = s["dim"], s["mlp_dim"]
    f = 2.0 * llm_dim * llm_dim + 2.0 * llm_dim * sd
    blk = (8.0 * K * sd * sd + 4.0 * K * K * sd            # self attention
           + 4.0 * K * sd * sd + 4.0 * sd * sd + 4.0 * K * sd  # text to proposals
           + 4.0 * K * sd * mlp                              # MLP
           + 4.0 * sd * sd + 4.0 * K * sd * sd + 4.0 * K * sd)  # proposals to text
    f += s["depth"] * blk + 4.0 * K * sd * sd + 4.0 * sd * sd + 4.0 * K * sd
    f += 2.0 * K * (sd * s["iou_head_hidden"] + s["iou_head_hidden"])
    f += 4.0 * K * sd * s["embed_head_hidden"]
    return rows * f


def predict_flops(cfg: Dict, traffic: Dict) -> float:
    """One predict call: CLIP and the projector, the decoder over the
    spliced rows, DINOv2 and its projection, the proposals' pooling (the
    upsample's adjoint on the masks), the selection head."""
    v, dn, L = cfg["vision"], cfg["dino"], cfg["llm"]
    B = traffic["images_per_batch"]
    R = B * traffic["rows_per_image"]
    K, G = cfg["max_proposals"], cfg["seg_grid"]
    n_img = (v["image_size"] // v["patch_size"]) ** 2
    T = traffic["text_len"] - 1 + n_img
    g = dn["image_size"] // dn["patch_size"]
    sd = cfg["select"]["dim"]
    f = B * vit_flops(v, v["num_hidden_layers"] + v["select_layer"] + 1)
    f += B * 2.0 * n_img * v["hidden_size"] * L["hidden_size"]
    f += decoder_flops(L, R, T)
    f += B * (vit_flops(dn, dn["num_hidden_layers"]) + 2.0 * g * g * dn["hidden_size"] * sd)
    f += B * K * 2.0 * (G * G * g + G * g * g + g * g * sd)
    f += select_flops(cfg["select"], L["hidden_size"], R, K)
    return f


# ---------------------------------------------------------------------------
# SAM AMG
# ---------------------------------------------------------------------------


def sam_encoder_flops(e: Dict) -> float:
    """One image through the encoder at its square input: windowed blocks
    compute on the windows' zero-padded tokens (as the model does), the
    MLP on the grid's."""
    E, p, ws = e["embed_dim"], e["patch_size"], e["window_size"]
    g = e["image_size"] // p
    n = g * g
    f = 2.0 * n * 3 * p * p * E
    for i in range(e["depth"]):
        if i in e["global_attn_indexes"]:
            side, tok, pairs = g, n, n * n
        else:
            gp = -(-g // ws) * ws
            side, tok, pairs = ws, gp * gp, (gp // ws) ** 2 * (ws * ws) ** 2
        f += 8.0 * tok * E * E + attention_flops(pairs, 1, E) + 4.0 * tok * side * E
        f += 4.0 * n * E * int(E * e["mlp_ratio"])
    C = e["out_chans"]
    return f + 2.0 * n * E * C + 18.0 * n * C * C


def twoway_flops(dc: Dict, P: int, N: int, L: int, shared: bool, head: bool) -> float:
    """The useful operations of the mask decoder on P prompts of N tokens
    against L image tokens (``chip_smoke.twoway_flops``): every product of
    the transformer (layer 0's keys-side projections once for a shared
    base), of the attention scores and values, and of the head (conv1,
    conv2, the hypernetwork product, the MLPs)."""
    C = dc["transformer_dim"]
    Ci = C // dc["attention_downsample_rate"]
    Csa = C
    mlp = dc["transformer_mlp_dim"]
    depth = dc["transformer_depth"]
    tok = P * N
    f = 0.0
    for i in range(depth):
        rows = L if (i == 0 and shared) else P * L
        f += 3 * 2.0 * rows * C * Ci
        f += 2.0 * P * L * Ci * C
        f += 2 * 2.0 * P * L * N * Ci
        f += 4 * 2.0 * tok * C * Csa + 2 * 2.0 * tok * N * Csa
        f += 4 * 2.0 * tok * C * Ci + 2 * 2.0 * tok * C * mlp
    f += 2 * 2.0 * P * L * C * Ci + 2 * 2.0 * P * L * N * Ci
    f += 2 * 2.0 * tok * C * Ci
    if head:
        nt = dc["num_multimask_outputs"] + 1
        co1, co2 = C // 4, C // 8
        f += 2.0 * P * L * C * 4 * co1 + 2.0 * 4 * P * L * co1 * 4 * co2
        f += 2.0 * 4 * P * L * 4 * nt * co2
        iou = [C] + [dc["iou_head_hidden_dim"]] * (dc["iou_head_depth"] - 1) + [nt]
        hyper = [C, C, C, C // 8]
        f += sum(2.0 * P * a * b for a, b in zip(iou, iou[1:]))
        f += nt * sum(2.0 * P * a * b for a, b in zip(hyper, hyper[1:]))
    return f


def decode_call_shape(cfg: Dict, amg: Dict) -> Tuple[int, int, int]:
    """(prompts, tokens, image tokens) of one decode call of AMG: the
    output tokens, one point and its pad point."""
    S = cfg["prompt"]["image_embedding_size"]
    N = cfg["decoder"]["num_multimask_outputs"] + 1 + 1 + 2
    return amg["points_per_batch"], N, S * S


def decode_bytes(cfg: Dict, amg: Dict) -> float:
    """One decode call on a shared image embedding: the embedding, its
    positional encoding and the tokens read once, the masks at 4S x 4S of
    every output token and the IoU written once, bf16."""
    P, N, L = decode_call_shape(cfg, amg)
    C = cfg["decoder"]["transformer_dim"]
    nt = cfg["decoder"]["num_multimask_outputs"] + 1
    return BF16 * (2 * L * C + P * N * C + P * nt * 16 * L + P * nt)


def amg_image_flops(cfg: Dict, amg: Dict) -> float:
    """One image at crop layers 0: the encoder and every decode call."""
    P, N, L = decode_call_shape(cfg, amg)
    calls = -(-amg["points_per_side"] ** 2 // P)
    return sam_encoder_flops(cfg["encoder"]) + calls * twoway_flops(cfg["decoder"], P, N, L,
                                                                    True, True)
