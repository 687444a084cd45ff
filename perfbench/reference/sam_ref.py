"""Plain float32 reference of SAM's everything-mode mask generation (AMG)
at crop layers 0: the ViT image encoder (windowed and global blocks with
the decomposed relative-position bias from the unscaled q, the conv neck),
the prompt encoder for one positive point and its pad point, the mask
decoder (two-way transformer, transposed-conv upscale, hypernetwork masks,
IoU head) on every grid point, the IoU and stability filters on the
low-resolution logits, box NMS, the top ``max_masks`` by predicted IoU, and
each survivor upscaled to the image and thresholded.

Weights are a dict keyed by the names of :func:`param_specs`; the
configuration is the benchmark's JSON document.  Imports nothing of the
program under test.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from reference.common import (ACTS, Prec, Weights, attend, bilinear_matrix, dense,
                              layer_norm, patchify)
from reference.llmseg_ref import Spec, _linear, _norm


def param_specs(cfg: Dict) -> List[Spec]:
    e, pr, dc = cfg["encoder"], cfg["prompt"], cfg["decoder"]
    E, g = e["embed_dim"], e["image_size"] // e["patch_size"]
    hd = E // e["num_heads"]
    out = [("image_encoder.pos_embed", (1, g, g, E), "small"),
           ("image_encoder.patch_embed.weight", (E, 3, e["patch_size"], e["patch_size"]), "fan_in"),
           ("image_encoder.patch_embed.bias", (E,), "small")]
    for i in range(e["depth"]):
        b = f"image_encoder.blocks.{i}."
        size = g if i in e["global_attn_indexes"] else e["window_size"]
        out += _norm(b + "norm1", E)
        out += [(b + "attn.rel_pos_h", (2 * size - 1, hd), e["rel_pos_init"]),
                (b + "attn.rel_pos_w", (2 * size - 1, hd), e["rel_pos_init"])]
        out += _linear(b + "attn.qkv", E, 3 * E) + _linear(b + "attn.proj", E, E)
        out += _norm(b + "norm2", E)
        hidden = int(E * e["mlp_ratio"])
        out += _linear(b + "mlp.fc1", E, hidden) + _linear(b + "mlp.fc2", hidden, E)
    C = e["out_chans"]
    out += [("image_encoder.neck.conv1.weight", (C, E, 1, 1), "fan_in")] + _norm(
        "image_encoder.neck.ln1", C)
    out += [("image_encoder.neck.conv2.weight", (C, C, 3, 3), "fan_in")] + _norm(
        "image_encoder.neck.ln2", C)
    D, mc = pr["embed_dim"], pr["mask_in_chans"]
    out += [("prompt_encoder.point_embeddings", (4, D), "unit"),
            ("prompt_encoder.not_a_point_embed", (1, D), "unit"),
            ("prompt_encoder.no_mask_embed", (1, D), "unit"),
            ("prompt_encoder.pe.gaussian", (2, D // 2), "unit")]
    md = "prompt_encoder.mask_downscale."
    out += [(md + "conv1.weight", (mc // 4, 1, 2, 2), "fan_in"), (md + "conv1.bias", (mc // 4,), "small")]
    out += _norm(md + "ln1", mc // 4)
    out += [(md + "conv2.weight", (mc, mc // 4, 2, 2), "fan_in"), (md + "conv2.bias", (mc,), "small")]
    out += _norm(md + "ln2", mc)
    out += [(md + "conv3.weight", (D, mc, 1, 1), "fan_in"), (md + "conv3.bias", (D,), "small")]
    d, nt = dc["transformer_dim"], dc["num_multimask_outputs"] + 1
    inner = d // dc["attention_downsample_rate"]
    out += [("mask_decoder.iou_token", (1, d), "unit"), ("mask_decoder.mask_tokens", (nt, d), "unit")]
    t = "mask_decoder.transformer."
    for i in range(dc["transformer_depth"]):
        b = f"{t}layers.{i}."
        out += _attn(b + "self_attn", d, d) + _norm(b + "norm1", d)
        out += _attn(b + "cross_attn_t2i", d, inner) + _norm(b + "norm2", d)
        out += _linear(b + "mlp.fc1", d, dc["transformer_mlp_dim"])
        out += _linear(b + "mlp.fc2", dc["transformer_mlp_dim"], d) + _norm(b + "norm3", d)
        out += _attn(b + "cross_attn_i2t", d, inner) + _norm(b + "norm4", d)
    out += _attn(t + "final_attn", d, inner) + _norm(t + "norm_final", d)
    out += [("mask_decoder.upscale_conv1.weight", (d // 4, d, 2, 2), "upscale"),
            ("mask_decoder.upscale_conv1.bias", (d // 4,), "small")]
    out += _norm("mask_decoder.upscale_ln", d // 4)
    out += [("mask_decoder.upscale_conv2.weight", (d // 8, d // 4, 2, 2), "upscale"),
            ("mask_decoder.upscale_conv2.bias", (d // 8,), "small")]
    for m in range(nt):
        dims = [d, d, d, d // 8]
        for j in range(3):
            out += _linear(f"mask_decoder.hyper_mlps.{m}.layers.{j}", dims[j], dims[j + 1])
    dims = [d] + [dc["iou_head_hidden_dim"]] * (dc["iou_head_depth"] - 1) + [nt]
    for j in range(len(dims) - 1):
        out += _linear(f"mask_decoder.iou_head.layers.{j}", dims[j], dims[j + 1])
    return out


def _attn(name: str, d: int, inner: int) -> List[Spec]:
    return (_linear(name + ".q", d, inner) + _linear(name + ".k", d, inner)
            + _linear(name + ".v", d, inner) + _linear(name + ".out", inner, d))


# ---------------------------------------------------------------------------
# Image encoder
# ---------------------------------------------------------------------------


def _relpos_attention(W: Weights, x: torch.Tensor, heads: int, P: Prec) -> torch.Tensor:
    """x (B, S, S, E) -> (B, S, S, E); bias q.Rh[y, y'] + q.Rw[x, x'] from
    the unscaled q."""
    B, S, _, E = x.shape
    T, hd = S * S, E // heads
    qkv = dense(x.reshape(B, T, E), W, "qkv", P).reshape(B, T, 3, heads, hd)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    rel = torch.arange(S, device=x.device)[:, None] - torch.arange(S, device=x.device)[None] + S - 1
    Rh, Rw = W("rel_pos_h")[rel], W("rel_pos_w")[rel]                # (S, S, hd)
    qg = q.reshape(B, S, S, heads, hd)
    rel_h = torch.einsum("byxnc,ykc->bnyxk", qg, Rh).reshape(B, heads, T, S)
    rel_w = torch.einsum("byxnc,xkc->bnyxk", qg, Rw).reshape(B, heads, T, S)

    def bias(b, t0, t1):
        return (rel_h[b, :, t0:t1, :, None] + rel_w[b, :, t0:t1, None, :]).reshape(heads, t1 - t0, T)

    o = attend(q, k, v, bias=bias)
    return dense(o.reshape(B, T, E), W, "proj", P).reshape(B, S, S, E)


def encode(W: Weights, cfg: Dict, image: np.ndarray, P: Prec, device) -> torch.Tensor:
    """uint8 (h, w, 3) -> image embedding (S, S, C): normalised, zero
    outside the image, at the square input."""
    e = cfg["encoder"]
    s_in, p, E = e["image_size"], e["patch_size"], e["embed_dim"]
    h, w = image.shape[:2]
    x = torch.zeros(1, s_in, s_in, 3, device=device)
    img = torch.from_numpy(np.ascontiguousarray(image)).to(device).float()
    mean = torch.tensor(cfg["pixel_mean"], device=device)
    std = torch.tensor(cfg["pixel_std"], device=device)
    x[0, :h, :w] = (img - mean) / std
    g = s_in // p
    x = P.linear(patchify(x, p), W("patch_embed.weight").reshape(E, -1), W("patch_embed.bias"))
    x = x.reshape(1, g, g, E) + W("pos_embed")
    eps, ws, act = e["layer_norm_eps"], e["window_size"], ACTS[e["mlp_act"]]
    for i in range(e["depth"]):
        Wb = W.sub(f"blocks.{i}.")
        h_ = layer_norm(x, Wb, "norm1", eps)
        if i in e["global_attn_indexes"]:
            h_ = _relpos_attention(Wb.sub("attn."), h_, e["num_heads"], P)
        else:       # zero-padded to whole windows; the pad takes part, unmasked
            pad = (-g) % ws
            gp = g + pad
            hw = F.pad(h_, (0, 0, 0, pad, 0, pad)).reshape(1, gp // ws, ws, gp // ws, ws, E)
            hw = hw.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, E)
            hw = _relpos_attention(Wb.sub("attn."), hw, e["num_heads"], P)
            hw = hw.reshape(1, gp // ws, gp // ws, ws, ws, E).permute(0, 1, 3, 2, 4, 5)
            h_ = hw.reshape(1, gp, gp, E)[:, :g, :g]
        x = x + h_
        x = x + dense(act(dense(layer_norm(x, Wb, "norm2", eps), Wb, "mlp.fc1", P)), Wb,
                      "mlp.fc2", P)
    C = e["out_chans"]
    x = P.linear(x, W("neck.conv1.weight").reshape(C, E))
    x = layer_norm(x, W, "neck.ln1", eps)
    cols = F.unfold(x.permute(0, 3, 1, 2), 3, padding=1)               # (1, C*9, g*g)
    x = P.linear(cols[0].t(), W("neck.conv2.weight").reshape(C, -1)).reshape(g, g, C)
    return layer_norm(x, W, "neck.ln2", eps)


# ---------------------------------------------------------------------------
# Prompt encoder and mask decoder
# ---------------------------------------------------------------------------


def _fourier(W: Weights, coords: torch.Tensor) -> torch.Tensor:
    c = 2.0 * math.pi * ((2.0 * coords - 1.0) @ W("pe.gaussian"))
    return torch.cat([torch.sin(c), torch.cos(c)], -1)


def _mlp_stack(W: Weights, name: str, x, n: int, P: Prec):
    for j in range(n):
        x = dense(x, W, f"{name}.layers.{j}", P)
        if j < n - 1:
            x = torch.relu(x)
    return x


def _conv_t(W: Weights, name: str, x: torch.Tensor, P: Prec) -> torch.Tensor:
    """2x2 stride-2 transposed conv, NHWC, weight (out, in, 2, 2) applied
    spatially flipped: y[2i+a, 2j+b, o] = sum_c x[i, j, c] w[o, c, 1-a, 1-b] + bias."""
    w = W(name + ".weight").flip(2, 3)                                  # (o, c, a, b)
    B, H, Wd, Ci = x.shape
    co = w.shape[0]
    wm = w.permute(2, 3, 0, 1).reshape(4 * co, Ci)                      # rows (a, b, o)
    y = P.linear(x.reshape(-1, Ci), wm).reshape(B, H, Wd, 2, 2, co)
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(B, 2 * H, 2 * Wd, co)
    return y + W(name + ".bias")


def decode(W: Weights, cfg: Dict, emb: torch.Tensor, points: torch.Tensor, P: Prec):
    """One positive point a prompt: emb (S, S, C), points (N, 2) input-frame
    pixels -> (low-res logits (N, nt-1, 4S, 4S), iou (N, nt-1)), the
    multimask outputs."""
    pr, dc = cfg["prompt"], cfg["decoder"]
    S, d = emb.shape[0], dc["transformer_dim"]
    eps, nh = dc["layer_norm_eps"], dc["transformer_num_heads"]
    Wp, Wd = W.sub("prompt_encoder."), W.sub("mask_decoder.")
    N = points.shape[0]
    pe = _fourier(Wp, (points.float() + 0.5) / pr["input_image_size"]) + Wp("point_embeddings")[1]
    sparse = torch.stack([pe, Wp("not_a_point_embed")[0].expand(N, -1)], 1)
    t = (torch.arange(S, dtype=torch.float32, device=emb.device) + 0.5) / S
    yy, xx = torch.meshgrid(t, t, indexing="ij")
    key_pe = _fourier(Wp, torch.stack([xx, yy], -1)).reshape(1, S * S, d)
    keys = (emb + Wp("no_mask_embed")[0]).reshape(1, S * S, d).expand(N, -1, -1)
    tok = torch.cat([Wd("iou_token"), Wd("mask_tokens")], 0)
    queries = torch.cat([tok[None].expand(N, -1, -1), sparse], 1)
    qpe = queries
    Wt = Wd.sub("transformer.")
    mha = _mha_heads(nh, P)
    for i in range(dc["transformer_depth"]):
        Wb = Wt.sub(f"layers.{i}.")
        if i == 0:
            queries = mha(Wb, "self_attn", queries, queries, queries)
        else:
            q = queries + qpe
            queries = queries + mha(Wb, "self_attn", q, q, queries)
        queries = layer_norm(queries, Wb, "norm1", eps)
        q, k = queries + qpe, keys + key_pe
        queries = layer_norm(queries + mha(Wb, "cross_attn_t2i", q, k, keys), Wb, "norm2", eps)
        h = dense(torch.relu(dense(queries, Wb, "mlp.fc1", P)), Wb, "mlp.fc2", P)
        queries = layer_norm(queries + h, Wb, "norm3", eps)
        q = queries + qpe
        keys = layer_norm(keys + mha(Wb, "cross_attn_i2t", k, q, queries), Wb, "norm4", eps)
    q, k = queries + qpe, keys + key_pe
    queries = layer_norm(queries + mha(Wt, "final_attn", q, k, keys), Wt, "norm_final", eps)
    gelu = ACTS["gelu_tanh"]
    up = _conv_t(Wd, "upscale_conv1", keys.reshape(N, S, S, d), P)
    up = gelu(layer_norm(up, Wd, "upscale_ln", eps))
    up = gelu(_conv_t(Wd, "upscale_conv2", up, P))                     # (N, 4S, 4S, d/8)
    nt = dc["num_multimask_outputs"] + 1
    hyper = torch.stack([_mlp_stack(Wd, f"hyper_mlps.{m}", queries[:, 1 + m], 3, P)
                         for m in range(nt)], 1)
    masks = torch.einsum("nmc,nhwc->nmhw", hyper, up)
    iou = _mlp_stack(Wd, "iou_head", queries[:, 0], dc["iou_head_depth"], P)
    return masks[:, 1:], iou[:, 1:]


def _mha_heads(heads: int, P: Prec):
    def mha(W: Weights, name: str, q, k, v):
        B, Tq, _ = q.shape
        qh = dense(q, W, name + ".q", P).reshape(B, Tq, heads, -1)
        kh = dense(k, W, name + ".k", P).reshape(B, k.shape[1], heads, -1)
        vh = dense(v, W, name + ".v", P).reshape(B, k.shape[1], heads, -1)
        return dense(attend(qh, kh, vh).reshape(B, Tq, -1), W, name + ".out", P)
    return mha


# ---------------------------------------------------------------------------
# AMG
# ---------------------------------------------------------------------------


def point_grid(n: int) -> np.ndarray:
    """(n*n, 2) cell centres in [0, 1], x fastest."""
    pts = np.linspace(1.0 / (2 * n), 1.0 - 1.0 / (2 * n), n)
    gx, gy = np.meshgrid(pts, pts)
    return np.stack([gx.reshape(-1), gy.reshape(-1)], -1)


def upscale_logits(low: torch.Tensor, hw, s_in: int) -> torch.Tensor:
    """(K, S, S) logits -> (K, h, w) float32 logits at the input frame's
    resolution."""
    M = bilinear_matrix(low.shape[-1], s_in, low.device)
    up = torch.einsum("oh,khw->kow", M, low.float())
    up = torch.einsum("pw,kow->kop", M, up)
    return up[:, :hw[0], :hw[1]]


def upscale(low: torch.Tensor, hw, s_in: int, threshold: float) -> torch.Tensor:
    """(K, S, S) logits -> (K, h, w) bool at the input frame's resolution."""
    return upscale_logits(low, hw, s_in) > threshold


def _greedy_nms(boxes, scores, keep, thresh: float):
    if thresh >= 1.0:           # IoU never exceeds 1: nothing is suppressed
        return keep
    order = torch.argsort(-torch.where(keep, scores, -torch.inf), stable=True)
    out = torch.zeros_like(keep)
    area = (boxes[:, 2] - boxes[:, 0]).clamp_min(0) * (boxes[:, 3] - boxes[:, 1]).clamp_min(0)
    kept: List[int] = []
    for i in order.tolist():
        if not bool(keep[i]):
            break
        if kept:
            kb = boxes[kept]
            lt = torch.maximum(kb[:, :2], boxes[i, :2])
            rb = torch.minimum(kb[:, 2:], boxes[i, 2:])
            inter = (rb - lt).clamp_min(0).prod(-1)
            union = area[kept] + area[i] - inter
            if bool((torch.where(union > 0, inter / union, 0.0) > thresh).any()):
                continue
        kept.append(i)
        out[i] = True
    return out


def mask_box(m: torch.Tensor):
    """Inclusive-edge xywh box of a bool (h, w) mask, zeros when empty."""
    ys = m.any(1).nonzero()
    xs = m.any(0).nonzero()
    if len(ys) == 0:
        return [0.0, 0.0, 0.0, 0.0]
    return [float(xs[0]), float(ys[0]), float(xs[-1] - xs[0]), float(ys[-1] - ys[0])]


@torch.no_grad()
def amg(tensors: Dict[str, torch.Tensor], cfg: Dict, amg_cfg: Dict, image: np.ndarray,
        precision: str = "fp32", device="cuda") -> Dict:
    """Everything-mode generation for one uint8 image.  Returns the survivors
    (``anns``: mask, area, bbox, predicted_iou, stability_score,
    point_coords, each as the program's annotations give them, sorted by
    area) and every candidate's low-res logits, IoU, stability and
    eligibility, for matching the program's annotations."""
    P = Prec(precision)
    W = Weights(tensors)
    e = cfg["encoder"]
    s_in = e["image_size"]
    h, w = image.shape[:2]
    emb = encode(W.sub("image_encoder."), cfg, image, P, device)
    pts = torch.tensor(point_grid(amg_cfg["points_per_side"]) * np.array([w, h]),
                       dtype=torch.float32, device=device)
    lows, ious = [], []
    B = amg_cfg["points_per_batch"]
    for c in range(0, pts.shape[0], B):
        m, i = decode(W, cfg, emb, pts[c:c + B], P)
        lows.append(m)
        ious.append(i)
    low = torch.cat(lows).flatten(0, 1)                               # (3P, S4, S4)
    iou = torch.cat(ious).reshape(-1)
    S4 = low.shape[-1]
    thr, off = cfg["mask_threshold"], amg_cfg["stability_score_offset"]
    lh, lw = max(h * S4 // s_in, 1), max(w * S4 // s_in, 1)
    region = torch.zeros(S4, S4, dtype=torch.bool, device=device)
    region[:lh, :lw] = True
    masked = torch.where(region, low, thr - 2.0 * off - 1.0)
    hi = (masked > thr + off).float().sum((-1, -2))
    lo = (masked > thr - off).float().sum((-1, -2))
    stab = torch.where(lo > 0, hi / lo, 0.0)
    binary = masked > thr
    nonempty = binary.any(-1).any(-1)
    keep = (iou > amg_cfg["pred_iou_thresh"]) & (stab >= amg_cfg["stability_score_thresh"]) & nonempty
    rows, cols = binary.any(-1), binary.any(-2)
    ar = torch.arange(S4, device=device)
    boxes = torch.stack([torch.where(cols, ar, S4).amin(-1), torch.where(rows, ar, S4).amin(-1),
                         torch.where(cols, ar, -1).amax(-1), torch.where(rows, ar, -1).amax(-1)],
                        -1).float() * (s_in / S4)
    keep = _greedy_nms(boxes, iou, keep, amg_cfg["box_nms_thresh"])
    order = torch.argsort(-torch.where(keep, iou, -torch.inf), stable=True)
    top = order[:min(amg_cfg["max_masks"], int(keep.sum()))]
    masks = upscale(low[top], (h, w), s_in, thr)
    anns = []
    for j, c in enumerate(top.tolist()):
        m = masks[j]
        area = int(m.sum())
        if area == 0:
            continue
        p = pts[c // 3]
        anns.append({"mask": m, "area": area, "bbox": mask_box(m),
                     "predicted_iou": float(iou[c]), "stability_score": float(stab[c]),
                     "point_coords": [[float(p[0]), float(p[1])]]})
    anns.sort(key=lambda a: a["area"], reverse=True)
    return {"anns": anns, "low": low, "iou": iou, "stability": stab, "eligible": keep,
            "points": pts, "hw": (h, w), "kth_iou": float(iou[top[-1]]) if len(top) else 0.0}
