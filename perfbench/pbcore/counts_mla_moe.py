"""Operations and bytes of LLM-Seg's ``predict`` with DeepSeek-V3's decoder
(``configs/llmseg_kimivl_a3b.json``: the decoder's keys at the top level),
counted as ``pbcore/counts.py`` counts: the work as the model defines it,
each input byte read once and each output byte written once, no
recomputation; the towers and the head by ``counts``' own functions.
"""

from __future__ import annotations

from typing import Dict, Tuple

from pbcore.counts import BF16, bound, causal_pairs, select_flops, vit_flops


def shape(cfg: Dict, traffic: Dict) -> Tuple[int, int]:
    """(rows, tokens a row) of the decoder in one call."""
    v = cfg["vision"]
    rows = traffic["images_per_batch"] * traffic["rows_per_image"]
    return rows, traffic["text_len"] - 1 + (v["image_size"] // v["patch_size"]) ** 2


def decoder_parts(cfg: Dict, rows: int, T: int) -> Dict[str, float]:
    """The decoder's operations in one call, by part: the MLA projections
    (q, kv_a, kv_b, o), the attention's two products over the causal pairs,
    the leading dense SwiGLU layers, the routers, the shared experts and the
    routed experts (each token through its top k)."""
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, dv, r = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                         cfg["kv_lora_rank"])
    n_layers, dense = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    moe = n_layers - dense
    tok = rows * T
    I, k, E = cfg["moe_intermediate_size"], cfg["num_experts_per_tok"], cfg["n_routed_experts"]
    proj = 2.0 * d * (H * (nope + rope) + r + rope) + 2.0 * r * H * (nope + dv) + 2.0 * H * dv * d
    return {
        "mla_projections": n_layers * tok * proj,
        "attention": n_layers * rows * 2.0 * causal_pairs(T, T) * H * ((nope + rope) + dv),
        "dense": dense * tok * 6.0 * d * cfg["intermediate_size"],
        "router": moe * tok * 2.0 * d * E,
        "shared_experts": moe * tok * 6.0 * d * I * cfg["n_shared_experts"],
        "routed_experts": moe * tok * k * 6.0 * d * I,
    }


def mla_attention_bound(cfg: Dict, rows: int, T: int) -> Tuple[float, str]:
    """Kernel A's least time a launch (one layer): q and k at (rows x heads,
    T, 192) read, v read and o written at 128, bf16; the causal pairs' two
    products."""
    H = cfg["num_attention_heads"]
    dqk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    dv = cfg["v_head_dim"]
    nbytes = BF16 * rows * H * T * (2 * dqk + 2 * dv)
    flops = rows * 2.0 * causal_pairs(T, T) * H * (dqk + dv)
    return bound(nbytes, flops)


def routed_experts_bound(cfg: Dict, rows: int, T: int) -> Tuple[float, str]:
    """The least time of one MoE layer's two grouped products: every
    expert's weights read once; the gathered pairs (tokens x top k) read,
    their gate-and-up output written and read again as the SwiGLU's
    product, the down output written, bf16."""
    d, I = cfg["hidden_size"], cfg["moe_intermediate_size"]
    pairs = rows * T * cfg["num_experts_per_tok"]
    w = cfg["n_routed_experts"] * 3 * d * I
    nbytes = BF16 * (w + pairs * (d + 2 * I) + pairs * (I + d))
    return bound(nbytes, pairs * 6.0 * d * I)


def predict_flops(cfg: Dict, traffic: Dict) -> float:
    """One predict call: CLIP and the projector, the decoder, DINOv2 and its
    projection, the proposals' pooling, the selection head (as
    ``counts.predict_flops`` with this decoder)."""
    v, dn = cfg["vision"], cfg["dino"]
    B = traffic["images_per_batch"]
    rows, T = shape(cfg, traffic)
    K, G = cfg["max_proposals"], cfg["seg_grid"]
    n_img = (v["image_size"] // v["patch_size"]) ** 2
    g = dn["image_size"] // dn["patch_size"]
    sd, d = cfg["select"]["dim"], cfg["hidden_size"]
    f = B * vit_flops(v, v["num_hidden_layers"] + v["select_layer"] + 1)
    f += B * 2.0 * n_img * v["hidden_size"] * d
    f += sum(decoder_parts(cfg, rows, T).values())
    f += B * (vit_flops(dn, dn["num_hidden_layers"]) + 2.0 * g * g * dn["hidden_size"] * sd)
    f += B * K * 2.0 * (G * G * g + G * g * g + g * g * sd)
    f += select_flops(cfg["select"], d, rows, K)
    return f
