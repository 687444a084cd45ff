"""Plain float32 reference of LLM-Seg's ``predict``: the CLIP tower, the
linear projector and the image-token splice, the decoder (LLaMA / Mistral
layout: RMSNorm, RoPE with the half rotation, grouped-query attention,
SwiGLU), the hidden state one left of the first ``[SEG]``, DINOv2 with its
LayerScale applied as a product (never folded), the 1x1 projection, the
bilinear upsample of the feature map to the proposals' grid and the masked
mean under each proposal, and the selection head (two two-way blocks, a
final cross attention, the IoP and embedding heads, the cosine score).

The configuration is the benchmark's own JSON document (``configs/``), and
the weights a dict keyed by the names in :func:`param_specs`.  Imports
nothing of the program under test.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from reference.common import (ACTS, Prec, Weights, attend, bilinear_matrix, dense,
                              layer_norm, patchify, rms_norm)

Spec = Tuple[str, Tuple[int, ...], str]


def vocab(cfg: Dict) -> int:
    return cfg["llm"]["vocab_size"] + cfg["added_tokens"]


def _vit_specs(prefix: str, c: Dict) -> List[Spec]:
    d, p = c["hidden_size"], c["patch_size"]
    n_tok = (c["image_size"] // p) ** 2 + 1
    out = [(prefix + "pos_embed", (1, n_tok, d), "small"),
           (prefix + "cls_token", (1, 1, d), "small"),
           (prefix + "patch_embed.weight", (d, 3, p, p), "fan_in")]
    if not c["pre_layernorm"]:      # CLIP's patch convolution has no bias
        out.append((prefix + "patch_embed.bias", (d,), "small"))
    for i in range(c["num_hidden_layers"]):
        b = f"{prefix}blocks.{i}."
        out += _norm(b + "norm1", d)
        for n in ("q", "k", "v", "out"):
            out += _linear(b + "attn." + n, d, d)
        out += _norm(b + "norm2", d)
        out += _linear(b + "mlp.fc1", d, c["intermediate_size"])
        out += _linear(b + "mlp.fc2", c["intermediate_size"], d)
        if c["layerscale"]:
            out += [(b + "ls1", (d,), "layerscale"), (b + "ls2", (d,), "layerscale")]
    out += _norm(prefix + "norm", d)
    if c["pre_layernorm"]:
        out += _norm(prefix + "pre_norm", d)
    return out


def _norm(name: str, d: int, bias: bool = True) -> List[Spec]:
    return [(name + ".weight", (d,), "scale")] + ([(name + ".bias", (d,), "small")] if bias else [])


def _linear(name: str, fan_in: int, fan_out: int, bias: bool = True) -> List[Spec]:
    return [(name + ".weight", (fan_out, fan_in), "fan_in")] + (
        [(name + ".bias", (fan_out,), "small")] if bias else [])


def _attn_specs(name: str, d: int, inner: int) -> List[Spec]:
    return (_linear(name + ".q", d, inner) + _linear(name + ".k", d, inner)
            + _linear(name + ".v", d, inner) + _linear(name + ".out", inner, d))


def param_specs(cfg: Dict) -> List[Spec]:
    """(name, shape, kind) of every weight, in a fixed order.  ``kind``
    says how it is drawn (``pbcore.weights``)."""
    L, s = cfg["llm"], cfg["select"]
    d, hd = L["hidden_size"], L["head_dim"]
    out = _vit_specs("llava.vision_tower.", cfg["vision"])
    out += _linear("llava.mm_projector", cfg["vision"]["hidden_size"], d)
    out.append(("llava.llm.embed_tokens.weight", (vocab(cfg), d), "small"))
    for i in range(L["num_hidden_layers"]):
        b = f"llava.llm.layers.{i}."
        out += _norm(b + "input_norm", d, bias=False)
        out += _linear(b + "attn.q", d, L["num_attention_heads"] * hd, bias=False)
        out += _linear(b + "attn.k", d, L["num_key_value_heads"] * hd, bias=False)
        out += _linear(b + "attn.v", d, L["num_key_value_heads"] * hd, bias=False)
        out += _linear(b + "attn.o", L["num_attention_heads"] * hd, d, bias=False)
        out += _norm(b + "post_norm", d, bias=False)
        out += _linear(b + "mlp.gate", d, L["intermediate_size"], bias=False)
        out += _linear(b + "mlp.up", d, L["intermediate_size"], bias=False)
        out += _linear(b + "mlp.down", L["intermediate_size"], d, bias=False)
    out += _norm("llava.llm.norm", d, bias=False)
    if not L["tie_word_embeddings"]:
        out += _linear("llava.llm.lm_head", d, vocab(cfg), bias=False)
    out += _vit_specs("dino.", cfg["dino"])
    sd = s["dim"]
    out += _linear("select.text_fc1", d, d) + _linear("select.text_fc2", d, sd)
    out += _linear("select.dino_conv", cfg["dino"]["hidden_size"], sd)
    for i in range(s["depth"]):
        b = f"select.blocks.{i}."
        out += _attn_specs(b + "self_attn", sd, sd) + _norm(b + "norm1", sd)
        out += _attn_specs(b + "cross_t2i", sd, sd) + _norm(b + "norm2", sd)
        out += _linear(b + "mlp.fc1", sd, s["mlp_dim"]) + _linear(b + "mlp.fc2", s["mlp_dim"], sd)
        out += _norm(b + "norm3", sd)
        out += _attn_specs(b + "cross_i2t", sd, sd) + _norm(b + "norm4", sd)
    out += _attn_specs("select.final_attn", sd, sd) + _norm("select.norm_final", sd)
    out += _linear("select.iou_head.layers.0", sd, s["iou_head_hidden"])
    out += _linear("select.iou_head.layers.1", s["iou_head_hidden"], 1)
    out += _linear("select.embedding_head.layers.0", sd, s["embed_head_hidden"])
    out += _linear("select.embedding_head.layers.1", s["embed_head_hidden"], sd)
    return out


# ---------------------------------------------------------------------------
# Towers
# ---------------------------------------------------------------------------


def vit(W: Weights, c: Dict, images: torch.Tensor, P: Prec, n_blocks: int,
        final_norm: bool) -> torch.Tensor:
    """(B, H, W, 3) -> (B, 1 + N, d): patches, positions, the class token,
    ``n_blocks`` pre-norm blocks (multi-head attention, MLP; LayerScale
    when the configuration has it)."""
    d, p, eps = c["hidden_size"], c["patch_size"], c["layer_norm_eps"]
    act = ACTS[c["hidden_act"]]
    B = images.shape[0]
    x = P.linear(patchify(images, p), W("patch_embed.weight").reshape(d, -1),
                 None if c["pre_layernorm"] else W("patch_embed.bias"))
    pos = W("pos_embed")[0]
    cls = (W("cls_token")[0] + pos[:1]).expand(B, 1, d)
    x = torch.cat([cls, x + pos[1:]], 1)
    if c["pre_layernorm"]:
        x = layer_norm(x, W, "pre_norm", eps)
    H = c["num_attention_heads"]
    for i in range(n_blocks):
        Wb = W.sub(f"blocks.{i}.")
        h = layer_norm(x, Wb, "norm1", eps)
        q, k, v = (dense(h, Wb, "attn." + n, P).reshape(B, -1, H, d // H) for n in "qkv")
        h = dense(attend(q, k, v).reshape(B, -1, d), Wb, "attn.out", P)
        x = x + (h * Wb("ls1") if c["layerscale"] else h)
        h = layer_norm(x, Wb, "norm2", eps)
        h = dense(act(dense(h, Wb, "mlp.fc1", P)), Wb, "mlp.fc2", P)
        x = x + (h * Wb("ls2") if c["layerscale"] else h)
    return layer_norm(x, W, "norm", eps) if final_norm else x


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, T, H, D) at positions 0..T-1, the half rotation [-x2, x1];
    the angles in float64."""
    T, D = x.shape[1], x.shape[3]
    inv = theta ** (-torch.arange(0, D, 2, dtype=torch.float64, device=x.device) / D)
    ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] * inv[None]
    cos = torch.cat([ang.cos(), ang.cos()], -1).float()[None, :, None, :]
    sin = torch.cat([ang.sin(), ang.sin()], -1).float()[None, :, None, :]
    x1, x2 = x.chunk(2, -1)
    return x * cos + torch.cat([-x2, x1], -1) * sin


def decoder(W: Weights, L: Dict, x: torch.Tensor, P: Prec) -> torch.Tensor:
    """Spliced input embeddings (R, T, d) -> final-norm hidden states."""
    R, T, d = x.shape
    H, Hkv, hd = L["num_attention_heads"], L["num_key_value_heads"], L["head_dim"]
    eps = L["rms_norm_eps"]
    act = ACTS[L["hidden_act"]]
    for i in range(L["num_hidden_layers"]):
        Wl = W.sub(f"layers.{i}.")
        h = rms_norm(x, Wl, "input_norm", eps)
        q = rope(dense(h, Wl, "attn.q", P, bias=False).reshape(R, T, H, hd), L["rope_theta"])
        k = rope(dense(h, Wl, "attn.k", P, bias=False).reshape(R, T, Hkv, hd), L["rope_theta"])
        v = dense(h, Wl, "attn.v", P, bias=False).reshape(R, T, Hkv, hd)
        k, v = (t.repeat_interleave(H // Hkv, dim=2) for t in (k, v))
        o = attend(q, k, v, causal=True).reshape(R, T, H * hd)
        x = x + dense(o, Wl, "attn.o", P, bias=False)
        h = rms_norm(x, Wl, "post_norm", eps)
        g = act(dense(h, Wl, "mlp.gate", P, bias=False)) * dense(h, Wl, "mlp.up", P, bias=False)
        x = x + dense(g, Wl, "mlp.down", P, bias=False)
    return rms_norm(x, W, "norm", eps)


# ---------------------------------------------------------------------------
# Selection head
# ---------------------------------------------------------------------------


def _mha(W: Weights, name: str, q, k, v, heads: int, P: Prec, key_mask=None):
    B, Tq, _ = q.shape
    qh = dense(q, W, name + ".q", P).reshape(B, Tq, heads, -1)
    kh = dense(k, W, name + ".k", P).reshape(B, k.shape[1], heads, -1)
    vh = dense(v, W, name + ".v", P).reshape(B, k.shape[1], heads, -1)
    o = attend(qh, kh, vh, key_mask=key_mask).reshape(B, Tq, -1)
    return dense(o, W, name + ".out", P)


def select_head(W: Weights, s: Dict, props, text, valid, P: Prec):
    """props (R, K, C), text (R, C), valid (R, K) -> similarity, pred_iou."""
    eps, nh = s["layer_norm_eps"], s["num_heads"]
    q, k = props, text[:, None, :]
    for i in range(s["depth"]):
        Wb = W.sub(f"blocks.{i}.")
        q = layer_norm(q + _mha(Wb, "self_attn", q, q, q, nh, P, valid), Wb, "norm1", eps)
        q = layer_norm(q + _mha(Wb, "cross_t2i", q, k, k, nh, P), Wb, "norm2", eps)
        h = dense(torch.relu(dense(q, Wb, "mlp.fc1", P)), Wb, "mlp.fc2", P)
        q = layer_norm(q + h, Wb, "norm3", eps)
        k = layer_norm(k + _mha(Wb, "cross_i2t", k, q, q, nh, P, valid), Wb, "norm4", eps)
    q = layer_norm(q + _mha(W, "final_attn", q, k, k, nh, P), W, "norm_final", eps)
    iou = torch.sigmoid(dense(torch.relu(dense(q, W, "iou_head.layers.0", P)), W,
                              "iou_head.layers.1", P))[..., 0]
    feat = dense(torch.relu(dense(q, W, "embedding_head.layers.0", P)), W,
                 "embedding_head.layers.1", P)
    f = feat / (feat.norm(dim=-1, keepdim=True) + 1e-8)
    t = text / (text.norm(dim=-1, keepdim=True) + 1e-8)
    sim = torch.einsum("rkd,rd->rk", f, t)
    return torch.where(valid, sim, -1.0), torch.where(valid, iou, 0.0)


# ---------------------------------------------------------------------------
# predict
# ---------------------------------------------------------------------------


def seg_positions(input_ids: torch.Tensor, image_pos: torch.Tensor, seg_id: int,
                  n_img: int) -> torch.Tensor:
    """Index in the spliced sequence of the token one left of each row's
    first [SEG] (the row must have one)."""
    out = []
    for r in range(input_ids.shape[0]):
        hits = (input_ids[r] == seg_id).nonzero()
        if len(hits) == 0:
            raise ValueError(f"row {r} has no [SEG]")
        t = int(hits[0]) - 1
        out.append(t if t < int(image_pos[r]) else t + n_img - 1)
    return torch.tensor(out, device=input_ids.device)


@torch.no_grad()
def predict_scores(tensors: Dict[str, torch.Tensor], cfg: Dict, batch: Dict,
                   precision: str = "fp32"):
    """(similarity (R, K), pred_iou (R, K)) in float32 for one batch in the
    program's batch layout."""
    P = Prec(precision)
    W = Weights(tensors)
    v, dn, s = cfg["vision"], cfg["dino"], cfg["select"]
    n_clip = v["num_hidden_layers"] + v["select_layer"] + 1
    clip = vit(W.sub("llava.vision_tower."), v, batch["images_clip"], P, n_clip, False)[:, 1:]
    img = dense(clip, W, "llava.mm_projector", P)                         # (B, N, d)
    row_img = batch["row_to_image"].long()
    ids = batch["input_ids"].long()
    emb = W("llava.llm.embed_tokens.weight")[ids]                           # (R, T, d)
    rows = []
    for r in range(ids.shape[0]):
        p = int(batch["image_pos"][r])
        rows.append(torch.cat([emb[r, :p], img[row_img[r]], emb[r, p + 1:]], 0))
    hidden = decoder(W.sub("llava.llm."), cfg["llm"], torch.stack(rows), P)
    idx = seg_positions(ids, batch["image_pos"], cfg["seg_token_id"], img.shape[1])
    seg = hidden[torch.arange(hidden.shape[0], device=hidden.device), idx]
    text = dense(torch.relu(dense(seg, W, "select.text_fc1", P)), W, "select.text_fc2", P)

    feats = vit(W.sub("dino."), dn, batch["images_dino"], P, dn["num_hidden_layers"],
                True)[:, 1:]
    feats = dense(feats, W, "select.dino_conv", P)                        # (B, g*g, C)
    B, _, C = feats.shape
    g, G = dn["image_size"] // dn["patch_size"], cfg["seg_grid"]
    M = bilinear_matrix(g, G, feats.device)
    segs = batch["sam_segs"].float()
    pooled = []
    for b in range(B):      # one image at a time: the upsampled map is G*G*C
        fmap = torch.einsum("oh,hwc->owc", M, feats[b].reshape(g, g, C))
        fmap = torch.einsum("pw,owc->opc", M, fmap)
        pooled.append(torch.einsum("kop,opc->kc", segs[b], fmap)
                      / (segs[b].sum((-1, -2))[:, None] + 1e-8))
    pooled = torch.stack(pooled)
    valid = batch["prop_valid"][row_img]
    return select_head(W.sub("select."), s, pooled[row_img], text, valid, P)
