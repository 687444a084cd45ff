"""Plain float32 reference of LLM-Seg's ``predict`` with DeepSeek-V3's
decoder (Kimi-VL-A3B-Instruct's language model) in place of the LLaMA:
LLM-Seg's towers, splice and head are ``llmseg_ref``'s, the decoder is
written out here from the published modeling code:

* multi-head latent attention without q compression: q = h W_q per head
  [q_nope 128 | q_pe 64]; [c_kv 512 | k_pe 64] = h W_kv_a; c_kv RMS-normed
  (eps 1e-6, ``DeepseekV3RMSNorm``'s default, as ``kv_a_layernorm`` is
  built) and expanded to [k_nope 128 | v 128] per head; RoPE on q_pe and on
  the one k_pe all heads share, each interleaved pair (x_2j, x_2j+1) turned
  and written to halves (j, j + 32), as ``apply_rotary_pos_emb`` permutes
  it; causal softmax with scale 192^-1/2; o through W_o.
* ``first_k_dense_replace`` dense SwiGLU layers, then MoE layers: s =
  sigmoid(h W_g) in float32, the experts the top k of s + the correction
  bias, their weights s there over its sum + 1e-20 times
  ``routed_scaling_factor``; each expert's SwiGLU on the tokens that chose
  it (one expert at a time, so that it fits), plus the shared experts.

The MoE layers follow the routing they are given (the program's, or the
control's), so that a tie that bf16 breaks the other way does not read as
a wrong score; :func:`predict_scores` then reports ``route_margin``: for
each token and MoE layer, how far the lowest given choice's own score
(s + b, float32) lies below its 6th best, 0 where they agree.  With no
routing given it routes by its own scores.

The configuration is the benchmark's JSON document (the decoder's published
keys at its top level, the towers' in their groups).  Imports nothing of
the program under test.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from reference import llmseg_ref
from reference.common import Prec, Weights, attend, bilinear_matrix, dense, rms_norm

KV_NORM_EPS = 1e-6


def vocab(cfg: Dict) -> int:
    return cfg["vocab_size"] + cfg["added_tokens"]


def _lin(name: str, fan_in: int, fan_out: int):
    return llmseg_ref._linear(name, fan_in, fan_out, bias=False)


def _norm(name: str, d: int):
    return llmseg_ref._norm(name, d, bias=False)


def _swiglu(prefix: str, d: int, width: int):
    return (_lin(prefix + "gate", d, width) + _lin(prefix + "up", d, width)
            + _lin(prefix + "down", width, d))


def param_specs(cfg: Dict):
    """(name, shape, kind) of every weight served in the configuration's
    dtype, in a fixed order: the towers, the projector and the head as
    ``llmseg_ref`` specifies them (at this decoder's width), then the
    decoder by the program's names.  A layer's routed experts are stacked
    as the program holds them: ``mlp.experts.gate_up`` (E 2I, d), expert
    e's gate rows then its up rows from row 2I e, and ``mlp.experts.down``
    (E d, I), expert e's from row d e."""
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, dv, r = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                         cfg["kv_lora_rank"])
    E, I = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    no_llama = {"hidden_size": d, "head_dim": 0, "num_attention_heads": 0,
                "num_key_value_heads": 0, "intermediate_size": 0, "num_hidden_layers": 0,
                "vocab_size": cfg["vocab_size"], "tie_word_embeddings": True}
    out = [s for s in llmseg_ref.param_specs(dict(cfg, llm=no_llama))
           if not s[0].startswith("llava.llm.")]
    out.append(("llava.llm.embed_tokens.weight", (vocab(cfg), d), "small"))
    for i in range(cfg["num_hidden_layers"]):
        b = f"llava.llm.layers.{i}."
        out += _norm(b + "input_norm", d)
        out += _lin(b + "attn.q", d, H * (nope + rope)) + _lin(b + "attn.kv_a", d, r + rope)
        out += _norm(b + "attn.kv_norm", r) + _lin(b + "attn.kv_b", r, H * (nope + dv))
        out += _lin(b + "attn.o", H * dv, d) + _norm(b + "post_norm", d)
        if i < cfg["first_k_dense_replace"]:
            out += _swiglu(b + "mlp.", d, cfg["intermediate_size"])
            continue
        out += _lin(b + "mlp.router", d, E)
        out += [(b + "mlp.experts.gate_up", (E * 2 * I, d), "fan_in"),
                (b + "mlp.experts.down", (E * d, I), "fan_in")]
        out += _swiglu(b + "mlp.shared.", d, I * cfg["n_shared_experts"])
    out += _norm("llava.llm.norm", d)
    if not cfg["tie_word_embeddings"]:
        out += _lin("llava.llm.lm_head", d, vocab(cfg))
    return out


def float32_specs(cfg: Dict):
    """(name, shape, kind) of the weights served in float32 whatever the
    configuration's dtype, as DeepSeek-V3's inference code keeps them:
    each MoE layer's router correction bias, drawn as a norm scale, 1 +
    0.1 N (its spread moves the choice, so a router that ignores it is
    seen)."""
    return [(f"llava.llm.layers.{i}.mlp.router.correction_bias", (cfg["n_routed_experts"],),
             "scale") for i in range(cfg["first_k_dense_replace"], cfg["num_hidden_layers"])]


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def rope_pairs(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, T, H, D) at positions 0..T-1: pair j = (x_2j, x_2j+1) turned by
    t theta^(-2j/D) and written to (j, j + D/2); the angles in float64."""
    T, D = x.shape[1], x.shape[3]
    inv = theta ** (-torch.arange(0, D, 2, dtype=torch.float64, device=x.device) / D)
    ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] * inv[None]
    cos, sin = ang.cos().float()[None, :, None, :], ang.sin().float()[None, :, None, :]
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], -1)


def _swiglu_fwd(x, W: Weights, prefix: str, P: Prec):
    h = F.silu(dense(x, W, prefix + "gate", P, bias=False)) * dense(x, W, prefix + "up", P,
                                                                     bias=False)
    return dense(h, W, prefix + "down", P, bias=False)


def mla(W: Weights, cfg: Dict, h: torch.Tensor, P: Prec) -> torch.Tensor:
    R, T, _ = h.shape
    H, nope, rope, dv, r = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                            cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"])
    q = dense(h, W, "q", P, bias=False).reshape(R, T, H, nope + rope)
    kv_a = dense(h, W, "kv_a", P, bias=False)
    c_kv = rms_norm(kv_a[..., :r], W, "kv_norm", KV_NORM_EPS)
    kv = dense(c_kv, W, "kv_b", P, bias=False).reshape(R, T, H, nope + dv)
    q = torch.cat([q[..., :nope], rope_pairs(q[..., nope:], cfg["rope_theta"])], -1)
    k_pe = rope_pairs(kv_a[..., r:][:, :, None, :], cfg["rope_theta"]).expand(R, T, H, rope)
    k = torch.cat([kv[..., :nope], k_pe], -1)
    o = torch.cat([attend(q[i:i + 1], k[i:i + 1], kv[i:i + 1, ..., nope:], causal=True)
                   for i in range(R)])                 # one row at a time: it fits
    return dense(o.reshape(R, T, H * dv), W, "o", P, bias=False)


def moe(W: Weights, cfg: Dict, h: torch.Tensor, P: Prec, given: Optional[torch.Tensor]):
    """(output, the experts used (N, k), route margin) of one MoE layer."""
    x = h.reshape(-1, h.shape[-1])
    k = cfg["num_experts_per_tok"]
    s = torch.sigmoid(dense(x, W, "router", P, bias=False))
    score = s + W("router.correction_bias")
    margin = 0.0
    if given is None:
        idx = torch.topk(score, k, dim=-1).indices
    else:
        idx = given.to(x.device).long()
        kth = torch.topk(score, k, dim=-1).values[:, -1]
        margin = float((kth - score.gather(1, idx).min(-1).values).clamp_min(0).max())
    w = s.gather(1, idx)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * cfg["routed_scaling_factor"]
    y = _swiglu_fwd(x, W, "shared.", P)
    I = cfg["moe_intermediate_size"]
    E, d = cfg["n_routed_experts"], x.shape[-1]
    gate_up = W("experts.gate_up").view(E, 2 * I, d)
    down = W("experts.down").view(E, d, I)
    for e in range(E):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if len(tok):
            xe = x[tok]
            he = F.silu(P.linear(xe, gate_up[e, :I])) * P.linear(xe, gate_up[e, I:])
            y.index_add_(0, tok, P.linear(he, down[e]) * w[tok, slot, None])
    return y.reshape(h.shape), idx, margin


def decoder(W: Weights, cfg: Dict, x: torch.Tensor, P: Prec,
            routes: Optional[List[torch.Tensor]] = None):
    """Spliced input embeddings (R, T, d) -> (final-norm hidden states, the
    experts each MoE layer used, the widest route margin)."""
    eps = cfg["rms_norm_eps"]
    used, margin = [], 0.0
    for i in range(cfg["num_hidden_layers"]):
        Wl = W.sub(f"layers.{i}.")
        x = x + mla(Wl.sub("attn."), cfg, rms_norm(x, Wl, "input_norm", eps), P)
        h = rms_norm(x, Wl, "post_norm", eps)
        if i < cfg["first_k_dense_replace"]:
            x = x + _swiglu_fwd(h, Wl, "mlp.", P)
            continue
        given = None if routes is None else routes[len(used)]
        y, idx, m = moe(Wl.sub("mlp."), cfg, h, P, given)
        x = x + y
        used.append(idx)
        margin = max(margin, m)
    return rms_norm(x, W, "norm", eps), used, margin


# ---------------------------------------------------------------------------
# predict
# ---------------------------------------------------------------------------


@torch.no_grad()
def predict_scores(tensors: Dict[str, torch.Tensor], cfg: Dict, batch: Dict,
                   precision: str = "fp32", routes: Optional[List[torch.Tensor]] = None):
    """{"sim", "iou"} (R, K) float32, the experts each MoE layer used
    ("routes") and the widest ``route_margin`` of the routes given (0 with
    none), for one batch in the program's batch layout."""
    P = Prec(precision)
    W = Weights(tensors)
    v, dn = cfg["vision"], cfg["dino"]
    n_clip = v["num_hidden_layers"] + v["select_layer"] + 1
    clip = llmseg_ref.vit(W.sub("llava.vision_tower."), v, batch["images_clip"], P, n_clip,
                          False)[:, 1:]
    img = dense(clip, W, "llava.mm_projector", P)
    row_img = batch["row_to_image"].long()
    ids = batch["input_ids"].long()
    emb = W("llava.llm.embed_tokens.weight")[ids]
    rows = []
    for r in range(ids.shape[0]):
        p = int(batch["image_pos"][r])
        rows.append(torch.cat([emb[r, :p], img[row_img[r]], emb[r, p + 1:]], 0))
    hidden, used, margin = decoder(W.sub("llava.llm."), cfg, torch.stack(rows), P, routes)
    idx = llmseg_ref.seg_positions(ids, batch["image_pos"], cfg["seg_token_id"], img.shape[1])
    seg = hidden[torch.arange(hidden.shape[0], device=hidden.device), idx]
    text = dense(torch.relu(dense(seg, W, "select.text_fc1", P)), W, "select.text_fc2", P)

    feats = llmseg_ref.vit(W.sub("dino."), dn, batch["images_dino"], P, dn["num_hidden_layers"],
                           True)[:, 1:]
    feats = dense(feats, W, "select.dino_conv", P)
    B, _, C = feats.shape
    g, G = dn["image_size"] // dn["patch_size"], cfg["seg_grid"]
    M = bilinear_matrix(g, G, feats.device)
    segs = batch["sam_segs"].float()
    pooled = []
    for b in range(B):
        fmap = torch.einsum("oh,hwc->owc", M, feats[b].reshape(g, g, C))
        fmap = torch.einsum("pw,owc->opc", M, fmap)
        pooled.append(torch.einsum("kop,opc->kc", segs[b], fmap)
                      / (segs[b].sum((-1, -2))[:, None] + 1e-8))
    pooled = torch.stack(pooled)
    valid = batch["prop_valid"][row_img]
    sim, iou = llmseg_ref.select_head(W.sub("select."), cfg["select"], pooled[row_img], text,
                                      valid, P)
    return {"sim": sim, "iou": iou, "routes": used, "route_margin": margin}
