"""The SAM two-way decode on the card: plain versions and kernels G, H, I.

Counterpart of ``llmseg_tpu.ops.twoway_kernel``.

* :func:`fused_twoway_plain` computes ``_kernel``'s function: the depth-2
  two-way transformer and its final attention, per prompt.
  :func:`fused_twoway_apply` is kernel I (``csrc/twoway_fused.cu``);
  ``TwoWayTransformer`` routes large prompt batches on the card to it.
* :func:`fused_decode_plain` computes ``_decode_kernel``'s function: the
  transformer, the IoU head, the hypernetwork MLPs and the permuted
  upscale, with a per-prompt base or a shared one (layer 0's keys-side
  projections computed once).  :func:`twoway_decode` is kernel H, in the
  same source as I.
* :func:`factored_decode_plain` is the port of ``factored_decode_ref``, and
  :func:`factored_decode` is kernel G, the port of
  ``_decode_kernel_factored``.
* :func:`fused_decode_apply` routes as the JAX function does: a shared base
  (one image embedding for more than one prompt) with ``factored`` goes to
  G, every other case to H.

Each wrapper runs its plain version for a tensor on the CPU; for a CUDA
tensor it launches its kernel or raises.

Kernel G works on the factored keys state.  In everything-mode mask
generation (AMG) every prompt of a chunk shares ONE image base (image
embedding + the dense no-mask prompt).  A prompt's keys state diverges
from it only through the image-to-token cross attentions, whose update has
rank <= heads*tokens + 1, and LayerNorm acts per row and per column, so
the keys state stays

    keys = rho (x)rows (base . diag sigma) + A^T B

with per-prompt rho (L,), A (R, L), B (R, C) and a shared column scale
sigma.  Every keys-side projection becomes rho (x) G + A^T (B W) + PE + b
with G = (base sigma) W and PE = pe W computed once per chunk
(:func:`factored_shared`), and norm4 becomes closed-form row statistics.
G (``csrc/factored_decode.cu``) is a sequence of launches of a few
hand-written kernels, all 64 prompts of a chunk per launch.  In bf16 the
four parts that sweep over the L image tokens are fused kernels on wgmma
and TMA (``csrc/factored_fused.cuh``: token-to-image attention in two
sweeps, image-to-token scores with their column softmax, norm4 with its
two products, the upscale tail), which keep the float32 scores and the
other intermediates over L out of device memory; the token-side steps
(and, in float32, every step) run on a strided batched GEMM with fused
epilogues, row and column softmaxes, LayerNorms, norm4's closed form and
small layout ops.  :class:`Program` records that
sequence with its operands; the C side runs the whole sequence from one
call, which counts as one launch of G.  ``Program.run_torch`` interprets
the same records with torch (the test of the sequence on the CPU).

Kernels H and I keep the keys state materialised, (P, L, C) in device
memory, and run a fixed sequence of launches written in C++, one C call a
launch; :class:`_TwOperands` hands it the weights and buffers.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Optional

import torch
from torch import nn

from llmseg_tpu_torch.models.layers import gelu_tanh
from llmseg_tpu_torch.ops.kernels import Kernel, library

FACTORED_DECODE = Kernel("factored_decode")   # kernel G, csrc/factored_decode.cu
TWOWAY_DECODE = Kernel("twoway_decode", source="twoway_fused")            # kernel H
TWOWAY_TRANSFORMER = Kernel("twoway_transformer", source="twoway_fused")  # kernel I
KERNELS = (FACTORED_DECODE, TWOWAY_DECODE, TWOWAY_TRANSFORMER)
LN_EPS = 1e-6


def should_fuse(num_prompts: int, num_image_tokens: int, image_pe=None,
                device=None) -> bool:
    """Route a decode to the fused kernels: large prompt batches on the card.
    A per-batch positional encoding is not supported by the fused path."""
    if image_pe is not None and image_pe.dim() == 4 and image_pe.shape[0] > 1:
        return False
    return (num_prompts >= 8 and num_image_tokens >= 1024
            and device is not None and torch.device(device).type == "cuda")


# ---------------------------------------------------------------------------
# Plain pieces (the JAX helpers with a leading prompt dimension)
# ---------------------------------------------------------------------------


def _w(lin: nn.Linear) -> torch.Tensor:
    """The JAX layout (in, out) of a Linear's weight."""
    return lin.weight.t()


def _dense(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """float32 accumulation plus the bias, cast to x's dtype."""
    return (torch.matmul(x.float(), _w(lin).float()) + lin.bias.float()).to(x.dtype)


def _contract(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    y = torch.matmul(a.float(), b.float())
    return y if out_dtype is None else y.to(out_dtype)


def _bd(x: torch.Tensor, nh: int) -> torch.Tensor:
    """(..., T, I) -> (..., nh*T, I) head-block-diagonal: row h*T+t is x[t]
    with every column outside head h's block zeroed."""
    T, I = x.shape[-2:]
    tiled = torch.cat([x] * nh, -2)
    r = torch.arange(nh * T, device=x.device) // T
    c = torch.arange(I, device=x.device) // (I // nh)
    return torch.where(r[:, None] == c[None, :], tiled, torch.zeros_like(tiled))


def _head_extract(o: torch.Tensor, T: int, nh: int) -> torch.Tensor:
    """(..., nh*T, I) -> (..., T, I): each column from its own head's block."""
    I = o.shape[-1]
    idx = (torch.arange(I, device=o.device) // (I // nh))[None, :] * T \
        + torch.arange(T, device=o.device)[:, None]
    return torch.gather(o, -2, idx.expand(*o.shape[:-2], T, I))


def _softmax(s: torch.Tensor, dim: int = -1) -> torch.Tensor:
    e = torch.exp(s - s.amax(dim, keepdim=True))
    return e / e.sum(dim, keepdim=True)


def _scaled_bd(x: torch.Tensor, nh: int) -> torch.Tensor:
    hd = x.shape[-1] // nh
    return _bd(x, nh) * torch.tensor(1.0 / math.sqrt(hd), dtype=x.dtype, device=x.device)


def _attn_small_q(p, q, k, v, nh: int, kh=None, vh=None):
    """Attention whose query side is small (the prompt tokens').  kh / vh:
    the keys-side projections, when they are computed beforehand."""
    qh = _dense(p.q, q)
    kh = _dense(p.k, k) if kh is None else kh
    vh = _dense(p.v, v) if vh is None else vh
    Tq = qh.shape[-2]
    s = _contract(_scaled_bd(qh, nh), kh.transpose(-1, -2))
    o = _contract(_softmax(s).to(vh.dtype), vh)
    return _dense(p.out, _head_extract(o, Tq, nh).to(q.dtype))


def _attn_small_k(p, q, k, v, nh: int, qh=None):
    """Attention whose key side is small: image rows attend to the prompt
    tokens, the softmax over the tokens of each head.  qh: the query
    projection, when it is computed beforehand."""
    qh = _dense(p.q, q) if qh is None else qh
    kh, vh = _dense(p.k, k), _dense(p.v, v)
    Tk = kh.shape[-2]
    s = _contract(qh, _scaled_bd(kh, nh).transpose(-1, -2))       # (..., Tq, nh*Tk)
    probs = _softmax(s.unflatten(-1, (nh, Tk))).flatten(-2).to(vh.dtype)
    return _dense(p.out, _contract(probs, _bd(vh, nh)).to(v.dtype))


def _attention(p, q, k, v, nh: int):
    if k.shape[-2] < q.shape[-2]:
        return _attn_small_k(p, q, k, v, nh)
    return _attn_small_q(p, q, k, v, nh)


def _block(p, queries, keys, query_pe, k_with_pe, nh: int, skip_first_pe: bool, pre=None):
    """One two-way block on (P, ., C) states.  ``pre``: layer 0's keys-side
    projections (kh, vh, qi) of a shared base, which then enters only
    through them and the residual."""
    if skip_first_pe:
        queries = _attention(p.self_attn, queries, queries, queries, nh)
    else:
        q = queries + query_pe
        queries = queries + _attention(p.self_attn, q, q, queries, nh)
    queries = p.norm1(queries)
    kh, vh, qi = (None, None, None) if pre is None else pre
    q = queries + query_pe
    queries = p.norm2(queries + _attn_small_q(p.cross_attn_t2i, q, k_with_pe, keys, nh,
                                              kh=kh, vh=vh))
    queries = p.norm3(queries + _dense(p.mlp.fc2, torch.relu(_dense(p.mlp.fc1, queries))))
    q = queries + query_pe
    keys = p.norm4(keys + _attn_small_k(p.cross_attn_i2t, k_with_pe, q, queries, nh, qh=qi))
    return queries, keys


def _transformer(twt, queries, keys, key_pe, nh: int, pre0=None):
    """``_transformer`` with a leading prompt dimension: queries (P, N, C),
    keys (P or 1, L, C), key_pe (L, C); ``pre0`` as ``_block``'s ``pre``."""
    query_pe = queries
    for i, p in enumerate(twt.layers):
        if i == 0 and pre0 is not None:
            queries, keys = _block(p, queries, keys, query_pe, None, nh, True, pre=pre0)
        else:
            queries, keys = _block(p, queries, keys, query_pe, keys + key_pe, nh, i == 0)
    q, k = queries + query_pe, keys + key_pe
    queries = twt.norm_final(queries + _attention(twt.final_attn, q, k, keys, nh))
    return queries, keys


def fused_twoway_plain(twt, image_embedding, image_pe, tokens, num_heads: int):
    """``_kernel``'s function.  image_embedding (P, S, S, C); image_pe (S, S,
    C) or (1, S, S, C); tokens (P, N, C).  Returns (queries (P, N, C), keys
    (P, S*S, C)) in the image dtype."""
    P, Hs, Ws, C = image_embedding.shape
    L = Hs * Ws
    keys = image_embedding.reshape(P, L, C)
    pe = image_pe.reshape(-1, L, C)[0].to(keys.dtype)
    return _transformer(twt, tokens.to(keys.dtype), keys, pe, num_heads)


def _decode_head(head: Dict, queries, y1):
    """The IoU head, the hypernetwork MLPs and the upscale in the permuted
    layout, from conv1's output y1 (P, L, 4*co1).  Returns (mask columns
    (P, L, 16*nt) float32, iou (P, 1, nt))."""
    nt = len(head["hyper"])
    iou = _mlp_stack(head["iou"], queries[:, 0:1])
    hyper = torch.cat([_mlp_stack(head["hyper"][n], queries[:, 1 + n:2 + n])
                       for n in range(nt)], 1)
    hbd = _hbd(hyper)
    co1 = y1.shape[-1] // 4
    w2, b2 = head["conv2"]
    parts = []
    for g1 in range(4):
        z = gelu_tanh(head["ln"](y1[..., g1 * co1:(g1 + 1) * co1]))
        z = gelu_tanh((_contract(z, w2) + b2.float()).to(z.dtype))
        parts.append(_contract(z, hbd.transpose(1, 2)))
    return torch.cat(parts, -1), iou


def fused_decode_plain(twt, decoder, image_embedding, image_pe, tokens, num_heads: int):
    """``_decode_kernel``'s function, unpermuted as ``fused_decode_apply``
    returns it.  image_embedding (P, S, S, C) per prompt, or (1, S, S, C)
    shared by the P > 1 prompts (then layer 0's keys-side projections are
    computed once from it); image_pe (S, S, C) or (1, S, S, C); tokens (P,
    N, C).  Returns (masks (P, nt, 4S, 4S), iou (P, nt)) in the image dtype."""
    Bi, Hs, Ws, C = image_embedding.shape
    P = tokens.shape[0]
    if Bi not in (1, P):
        raise ValueError(f"image embeddings {Bi} for {P} prompts")
    L = Hs * Ws
    keys = image_embedding.reshape(Bi, L, C)
    dt = keys.dtype
    pe = image_pe.reshape(-1, L, C)[0].to(dt)
    pre0 = None
    if Bi == 1 and P > 1:
        l0, base = twt.layers[0], keys[0]
        k1pe = base + pe
        pre0 = (_dense(l0.cross_attn_t2i.k, k1pe), _dense(l0.cross_attn_t2i.v, base),
                _dense(l0.cross_attn_i2t.q, k1pe))
    queries, keys = _transformer(twt, tokens.to(dt), keys, pe, num_heads, pre0)
    head = decode_head_params(decoder)
    w1, b1 = head["conv1"]
    y1 = (_contract(keys, w1) + b1.float()).to(dt)
    cols, iou = _decode_head(head, queries, y1)
    nt = len(head["hyper"])
    return unpermute_masks(cols.to(dt), P, Hs, Ws, nt), iou[:, 0].to(dt)


def _mlp_stack(stack, x):
    n = len(stack.layers)
    for i, lin in enumerate(stack.layers):
        x = _dense(lin, x)
        if i < n - 1:
            x = torch.relu(x)
    return x


def _rowmean(x: torch.Tensor) -> torch.Tensor:
    return x.float().mean(-1)


def factored_shared(twt, base: torch.Tensor, pe: torch.Tensor, conv1_w: torch.Tensor) -> Dict:
    """Shared precomputes of one image (the same for every chunk of it).
    base (L, C) = image embedding + dense prompt; pe (L, C); conv1_w the
    upscale's first conv in matmul form (C, 4*C1)."""
    layers = twt.layers
    depth = len(layers)
    dt = base.dtype
    l0 = layers[0]
    pe = pe.to(dt)
    bpe = base + pe
    sh = {"kh1": _dense(l0.cross_attn_t2i.k, bpe),
          "vh1": _dense(l0.cross_attn_t2i.v, base),
          "qi1": _dense(l0.cross_attn_i2t.q, bpe),
          "blocks": []}
    sigma = torch.ones(base.shape[-1], device=base.device)
    stats = [(_rowmean(base), _rowmean(base.float().square()))]
    for i in range(1, depth):
        sigma = sigma * layers[i - 1].norm4.weight.float()
        bs = (base.float() * sigma).to(dt)
        t2i, i2t = layers[i].cross_attn_t2i, layers[i].cross_attn_i2t
        sh["blocks"].append({
            "Gk": _contract(bs, _w(t2i.k), dt), "Gv": _contract(bs, _w(t2i.v), dt),
            "Gq": _contract(bs, _w(i2t.q), dt),
            "PEk": _contract(pe, _w(t2i.k), dt), "PEq": _contract(pe, _w(i2t.q), dt)})
        stats.append((_rowmean(bs), _rowmean(bs.float().square())))
    sh["stats_m"] = torch.stack([m for m, _ in stats])        # (depth, L)
    sh["stats_q"] = torch.stack([q for _, q in stats])
    sigma = sigma * layers[depth - 1].norm4.weight.float()
    bs = (base.float() * sigma).to(dt)
    fa = twt.final_attn
    sh["Gkf"] = _contract(bs, _w(fa.k), dt)
    sh["Gvf"] = _contract(bs, _w(fa.v), dt)
    sh["PEkf"] = _contract(pe, _w(fa.k), dt)
    sh["Gc1"] = _contract(bs, conv1_w, dt)
    sh["base"] = base
    return sh


def _fact_proj_scores(qbd, G, PE, lin, rho, At, Bmat):
    """qbd @ proj^T without materialising proj = rho (x) G + At^T (B W) + PE + b.
    qbd (P, M, Ci); rho (P, 1, L); At (P, R, L); Bmat (P, R, C)."""
    dt = qbd.dtype
    s = _contract(qbd, G.t()) * rho
    bw = _contract(Bmat, _w(lin), dt)
    s = s + _contract(_contract(qbd, bw.transpose(-1, -2), dt), At)
    s = s + _contract(qbd, PE.t())
    return s + (qbd.float() * lin.bias.float()).sum(-1, keepdim=True)


def _fact_attend_v(probs, Gv, lin, rho, At, Bmat):
    """probs @ vh without materialising vh = rho (x) Gv + At^T (B Wv) + bv."""
    dt = Gv.dtype
    o = _contract((probs * rho).to(dt), Gv)
    bw = _contract(Bmat, _w(lin), dt)
    pa = _contract(probs.to(At.dtype), At.transpose(-1, -2), dt)
    o = o + _contract(pa, bw)
    return o + probs.sum(-1, keepdim=True) * lin.bias.float()


def _fact_norm4(norm, m, q, base, sigma_bbar, rho, Abar, Bbar):
    """Closed-form LayerNorm over rho (x) (base sigma) + Abar^T Bbar.
    m, q (L,) shared row stats; returns (rho', A', B')."""
    C = base.shape[-1]
    dt = Abar.dtype
    Af = Abar.float()
    bmean = Bbar.float().sum(-1, keepdim=True) / C
    mu = rho * m + (bmean * Af).sum(1, keepdim=True)
    cross = rho * (_contract(sigma_bbar, base.t()) * Af).sum(1, keepdim=True)
    gram = _contract(Bbar, Bbar.transpose(-1, -2))
    quad = (_contract(gram.to(dt), Abar) * Af).sum(1, keepdim=True)
    e2 = rho.square() * q + (2.0 * cross + quad) / C
    inv = torch.rsqrt(e2 - mu.square() + LN_EPS)
    scale, bias = norm.weight.float(), norm.bias.float()
    P, _, L = Abar.shape
    a_new = torch.cat([Abar * inv.to(dt), (-inv * mu).to(dt),
                       torch.ones(P, 1, L, dtype=dt, device=Abar.device)], 1)
    b_new = torch.cat([(Bbar.float() * scale).to(dt),
                       scale.to(dt).expand(P, 1, C), bias.to(dt).expand(P, 1, C)], 1)
    return rho * inv, a_new, b_new


def _pad_rows(rows: int) -> int:
    """Zero rank rows appended so that rows + 2 (norm4's) is a multiple of 8."""
    return -(rows + 2) % 8


def factored_prompt(twt, sh: Dict, tokens: torch.Tensor, nh: int):
    """The prompts through the two-way transformer in factored form.
    tokens (P, N, C).  Returns (queries (P, N, C), rho (P, 1, L),
    At (P, R, L), B (P, R, C))."""
    layers = twt.layers
    L, C = sh["base"].shape
    dt = sh["base"].dtype
    P = tokens.shape[0]
    dev = tokens.device
    query_pe = queries = tokens
    rho = torch.ones(P, 1, L, device=dev)
    At = Bmat = None
    sigma = torch.ones(C, device=dev)
    for i, p in enumerate(layers):
        if i == 0:
            queries = _attn_small_q(p.self_attn, queries, queries, queries, nh)
        else:
            q = queries + query_pe
            queries = queries + _attn_small_q(p.self_attn, q, q, queries, nh)
        queries = p.norm1(queries)

        ca = p.cross_attn_t2i
        qh = _dense(ca.q, queries + query_pe)
        Tq = qh.shape[-2]
        qbd = _scaled_bd(qh, nh)
        if i == 0:
            probs = _softmax(_contract(qbd, sh["kh1"].t())).to(dt)
            o = _contract(probs, sh["vh1"])
        else:
            blk = sh["blocks"][i - 1]
            probs = _softmax(_fact_proj_scores(qbd, blk["Gk"], blk["PEk"], ca.k, rho, At, Bmat))
            o = _fact_attend_v(probs, blk["Gv"], ca.v, rho, At, Bmat)
        queries = p.norm2(queries + _dense(ca.out, _head_extract(o, Tq, nh).to(dt)))
        queries = p.norm3(queries + _dense(p.mlp.fc2, torch.relu(_dense(p.mlp.fc1, queries))))

        ia = p.cross_attn_i2t
        kh = _dense(ia.k, queries + query_pe)
        vh = _dense(ia.v, queries)
        kbd = _scaled_bd(kh, nh)
        if i == 0:
            s = _contract(kbd, sh["qi1"].t())
        else:
            blk = sh["blocks"][i - 1]
            s = _fact_proj_scores(kbd, blk["Gq"], blk["PEq"], ia.q, rho, At, Bmat)
        N = kh.shape[-2]
        Pr = _softmax(s.reshape(P, nh, N, L), 2).reshape(P, nh * N, L)
        M = _contract(_bd(vh, nh), _w(ia.out), dt)
        ab = [Pr.to(dt), torch.ones(P, 1, L, dtype=dt, device=dev)]
        bb = [M, ia.out.bias.to(dt).expand(P, 1, C)]
        if At is not None:
            ab, bb = [At] + ab, [Bmat] + bb
        pad = _pad_rows(sum(a.shape[1] for a in ab))
        if pad:
            ab.append(torch.zeros(P, pad, L, dtype=dt, device=dev))
            bb.append(torch.zeros(P, pad, C, dtype=dt, device=dev))
        Abar, Bbar = torch.cat(ab, 1), torch.cat(bb, 1)
        sig_bbar = (Bbar.float() * sigma).to(dt)
        rho, At, Bmat = _fact_norm4(p.norm4, sh["stats_m"][i], sh["stats_q"][i], sh["base"],
                                    sig_bbar, rho, Abar, Bbar)
        sigma = sigma * p.norm4.weight.float()

    fa = twt.final_attn
    qh = _dense(fa.q, queries + query_pe)
    qbd = _scaled_bd(qh, nh)
    probs = _softmax(_fact_proj_scores(qbd, sh["Gkf"], sh["PEkf"], fa.k, rho, At, Bmat))
    o = _fact_attend_v(probs, sh["Gvf"], fa.v, rho, At, Bmat)
    queries = twt.norm_final(queries + _dense(fa.out, _head_extract(o, qh.shape[-2], nh).to(dt)))
    return queries, rho, At, Bmat


def _hbd(hyper: torch.Tensor) -> torch.Tensor:
    """(P, nt, co2) -> (P, 4*nt, 4*co2) block-diagonal over the 4 sub-pixel groups."""
    nt, co2 = hyper.shape[-2:]
    h = torch.cat([torch.cat([hyper] * 4, -2)] * 4, -1)
    r = torch.arange(4 * nt, device=hyper.device) // nt
    c = torch.arange(4 * co2, device=hyper.device) // co2
    return torch.where(r[:, None] == c[None, :], h, torch.zeros_like(h))


def factored_decode_tail(head: Dict, sh: Dict, queries, rho, At, Bmat):
    """IoU head, hypernetwork and the permuted-layout upscale on the factored
    keys state.  Returns (mask columns (P, L, 16*nt) float32, iou (P, 1, nt))."""
    w1, b1 = head["conv1"]
    y1 = (sh["Gc1"].float() * rho.transpose(1, 2)
          + _contract(At.transpose(1, 2), _contract(Bmat, w1, At.dtype))
          + b1.float()).to(At.dtype)
    return _decode_head(head, queries, y1)


def convt_as_matmul(conv) -> tuple:
    """A 2x2 stride-2 transposed conv (weight (out, in, 2, 2), the bridge's
    transpose of the JAX (2, 2, in, out) kernel) -> (w (in, 4*out), b
    (4*out,)) with columns (di, dj, out).  JAX applies the kernel spatially
    flipped: y[2i+di, 2j+dj, o] = sum_c x[i, j, c] * w[1-di, 1-dj, c, o]."""
    w = conv.weight.flip(2, 3)                      # (out, in, di, dj)
    ci, co = w.shape[1], w.shape[0]
    return (w.permute(1, 2, 3, 0).reshape(ci, 4 * co), conv.bias.repeat(4))


def decode_head_params(decoder) -> Dict:
    return {"conv1": convt_as_matmul(decoder.upscale_conv1), "ln": decoder.upscale_ln,
            "conv2": convt_as_matmul(decoder.upscale_conv2),
            "hyper": list(decoder.hyper_mlps), "iou": decoder.iou_head}


def unpermute_masks(masks_perm: torch.Tensor, P: int, Hs: int, Ws: int, nt: int):
    """Mask columns (di1, dj1, di2, dj2, token) per low-res pixel -> (P, nt,
    4Hs, 4Ws); final pixel (4i + 2 di1 + di2, 4j + 2 dj1 + dj2)."""
    m = masks_perm.reshape(P, Hs, Ws, 2, 2, 2, 2, nt).permute(0, 7, 1, 3, 5, 2, 4, 6)
    return m.reshape(P, nt, 4 * Hs, 4 * Ws)


def factored_decode_plain(twt, decoder, image_embedding, image_pe, tokens, num_heads: int):
    """Port of ``factored_decode_ref``.  image_embedding (1, S, S, C), the
    shared base; image_pe (S, S, C) or (1, S, S, C); tokens (P, N, C).
    Returns (masks (P, nt, 4S, 4S), iou (P, nt)) in the image dtype."""
    Bi, Hs, Ws, C = image_embedding.shape
    if Bi != 1:
        raise ValueError("the factored decode needs a shared base")
    L = Hs * Ws
    base = image_embedding.reshape(L, C)
    head = decode_head_params(decoder)
    sh = factored_shared(twt, base, image_pe.reshape(-1, L, C)[0], head["conv1"][0].to(base.dtype))
    q, rho, At, Bm = factored_prompt(twt, sh, tokens.to(base.dtype), num_heads)
    cols, iou = factored_decode_tail(head, sh, q, rho, At, Bm)
    nt = len(head["hyper"])
    return (unpermute_masks(cols.to(base.dtype), tokens.shape[0], Hs, Ws, nt),
            iou[:, 0].to(base.dtype))


# ---------------------------------------------------------------------------
# Kernel G: the launch sequence
# ---------------------------------------------------------------------------

# operation codes of csrc/factored_decode.cu, and the fixed record layout
OP_GEMM, OP_ADD, OP_LAYERNORM, OP_SOFTMAX_ROWS, OP_SOFTMAX_COLS, OP_BD, OP_HEAD_EXTRACT, \
    OP_COLSCALE_ROUND, OP_CAST, OP_SETROWS, OP_BPREP, OP_NORM4, OP_HBD, \
    OP_T2I, OP_I2T, OP_NORM4_FUSED, OP_UPSCALE = range(17)
OP_NAMES = ("gemm", "add", "layernorm", "softmax_rows", "softmax_cols", "bd", "head_extract",
            "colscale_round", "cast", "setrows", "bprep", "norm4", "hbd",
            "t2i", "i2t", "norm4_fused", "upscale")
FUSED_TILE = 64        # the L columns of a fused kernel's tile (csrc/factored_fused.cuh)
FUSED_PARTS = ("t2i", "i2t", "norm4", "upscale")   # the parts with a fused record
N_INTS, N_PTRS, N_FLOATS = 24, 12, 4
# the parts of the decode that g_program tags its records with: token-to-image
# attention, image-to-token scores and the rank update, norm4 with its two
# products, the upscale tail, and the token-side rest
REGIONS = ("t2i", "i2t", "norm4", "upscale", "token")
ACT_NONE, ACT_RELU, ACT_GELU = 0, 1, 2
GEMM_BETA, GEMM_ROWADD, GEMM_BIAS, GEMM_OUTER, GEMM_COLSCALE, GEMM_ROWMAT = 1, 2, 4, 8, 16, 32


def _view(t: torch.Tensor, off: int, size, stride) -> torch.Tensor:
    return t.as_strided(size, stride, t.storage_offset() + off)


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    return x.to(dtype).float()


def _act(x: torch.Tensor, act: int, dtype) -> torch.Tensor:
    if act == ACT_NONE:
        return x
    x = _round(x, dtype)
    return torch.relu(x) if act == ACT_RELU else gelu_tanh(x)


def _norm4_apply(x1v, x2v, abuf, bmean, rho, m, q, Z, zs, R, L, C) -> None:
    """norm4's closed form from X1, X2 (Z, R, L float32), in place on abuf
    and rho (see :meth:`Program.norm4`)."""
    av = _view(*abuf, (Z, R + 2, L), (zs, L, 1))
    af = av[:, :R].float()
    rv = _view(*rho, (Z, 1, L), (L, L, 1))
    bm = _view(*bmean, (Z, R, 1), (R, 1, 0))
    mu = rv * m + (bm * af).sum(1, keepdim=True)
    cross = rv * (x1v * af).sum(1, keepdim=True)
    quad = (x2v * af).sum(1, keepdim=True)
    e2 = rv.square() * q + (2.0 * cross + quad) / C
    inv = torch.rsqrt(e2 - mu.square() + LN_EPS)
    dt = av.dtype
    av[:, :R].copy_(av[:, :R] * inv.to(dt))
    av[:, R:R + 1].copy_(-inv * mu)
    av[:, R + 1].fill_(1.0)
    rv.copy_(rv * inv)


def _fact_scores(q, G, PE, qbw, av, rsb, rv, Z, M, R):
    """The fused records' scores (Z, M, L) float32, the terms in the order
    of the unfused records: rho (x) (q G^T), + qbw A, + q PE^T + rsb."""
    s = torch.matmul(q, G.float().t())
    if rv is not None:
        s = s * rv
    if R:
        s = _view(*qbw, (Z, M, R), (M * R, R, 1)).float() @ av + s
    if PE is not None:
        s = s + torch.matmul(q, PE.float().t())
    if rsb is not None:
        s = s + _view(*rsb, (Z, M, 1), (M, 1, 0))
    return s


class Program:
    """A recorded sequence of kernel G's operations.  Each record keeps its
    operands (tensor, element offset), its integer and float arguments, and
    a torch interpretation of the same operation."""

    def __init__(self):
        self.records: List[tuple] = []
        self.regions: List[str] = []   # each record's part of the decode (REGIONS)
        self.region = "token"
        self.flops = 0.0   # the GEMMs' useful operations (block-diagonal zeros excluded)

    def _add(self, op, ints, ptrs, floats, emu):
        if len(ints) > N_INTS or len(ptrs) > N_PTRS or len(floats) > N_FLOATS:
            raise ValueError("record too long")
        self.records.append((op, ints, ptrs, floats, emu))
        self.regions.append(self.region)

    # -- operations ----------------------------------------------------------

    def gemm(self, a, b, c, Z, M, N, K, sa, sb, sc, *, alpha=1.0, colscale=None,
             beta=None, rowadd=None, rowmat=None, bias=None, outer=False, act=ACT_NONE,
             useful=1.0):
        """c[z] (M, N) = epilogue(alpha * a[z] (M, K) @ b[z] (K, N)).  a, b, c,
        beta are (tensor, offset); sa = (z, m, k), sb = (z, k, n) and sc =
        (z, m, n) element strides (beta, a float32 input, shares sc).
        colscale / rowadd are (float32 tensor, z stride); bias float32 (N,);
        rowmat (tensor, row stride) an (M, N) matrix shared by every z.
        Epilogue: *colscale[n], + beta, + rowmat[m, n] * rowadd[m] (with
        ``rowmat``) or + rowadd[m], + bias[n] (or rowadd[m] * bias[n] with
        ``outer``), then round, act, round.  ``useful``: the share of the product's operations that are not
        multiplications by the zeros of a block-diagonal operand."""
        self.flops += 2.0 * Z * M * N * K * useful
        flags = ((GEMM_BETA if beta is not None else 0)
                 | (GEMM_ROWADD if rowadd is not None and not outer and rowmat is None else 0)
                 | (GEMM_ROWMAT if rowmat is not None else 0)
                 | (GEMM_BIAS if bias is not None and not outer else 0)
                 | (GEMM_OUTER if outer else 0)
                 | (GEMM_COLSCALE if colscale is not None else 0))
        if outer and (rowadd is None or bias is None or rowmat is not None):
            raise ValueError("outer needs rowadd and bias, and no rowmat")
        if rowmat is not None and rowadd is None:
            raise ValueError("rowmat needs rowadd")
        for t, _ in (a, b, c) + ((beta,) if beta is not None else ()):
            if t.dtype not in (torch.float32, torch.bfloat16):
                raise ValueError(f"gemm operand dtype {t.dtype}")
        if beta is not None and beta[0].dtype != torch.float32:
            raise ValueError("beta input must be float32")

        def emu():
            acc = torch.matmul(_view(*a, (Z, M, K), sa).float(),
                               _view(*b, (Z, K, N), sb).float()) * alpha
            if colscale is not None:
                acc = acc * _view(colscale[0], 0, (Z, 1, N), (colscale[1], 0, 1))
            if beta is not None:
                acc = _view(*beta, (Z, M, N), sc) + acc
            if rowadd is not None:
                r = _view(rowadd[0], 0, (Z, M, 1), (rowadd[1], 1, 0))
                if rowmat is not None:
                    acc = _view(rowmat[0], 0, (1, M, N), (0, rowmat[1], 1)).float() * r + acc
                else:
                    acc = acc + (r * bias if outer else r)
            if bias is not None and not outer:
                acc = acc + bias
            out = _view(*c, (Z, M, N), sc)
            out.copy_(_act(acc, act, out.dtype))

        cs, ra, rm = colscale or (None, 0), rowadd or (None, 0), rowmat or (None, 0)
        self._add(OP_GEMM, [Z, M, N, K, *sa, *sb, *sc, _isbf(a), _isbf(b), _isbf(c), flags,
                            cs[1], ra[1], act, rm[1],
                            int(rm[0] is not None and rm[0].dtype == torch.bfloat16)],
                  [a, b, c, beta, (cs[0], 0), (ra[0], 0), (bias, 0), (rm[0], 0)], [alpha], emu)

    def add(self, x, y, out, n):
        """out = round(x + y), n contiguous elements of one dtype."""
        def emu():
            _view(*out, (n,), (1,)).copy_(_view(*x, (n,), (1,)) + _view(*y, (n,), (1,)))
        self._add(OP_ADD, [n, _isbf(out)], [x, y, out], [], emu)

    def layernorm(self, x, out, rows, C, xs, os_, w, b, *, res=None, gelu=False):
        """out[r] = LN(round(x[r] + res[r])) (eps 1e-6, float32 statistics),
        rounded, then tanh-GELU and rounded again with ``gelu``.  Rows of C
        elements with row strides xs (x and res) and os_ (out); C <= 1024."""
        def emu():
            xv = _view(*x, (rows, C), (xs, 1))
            if res is not None:
                xv = xv + _view(*res, (rows, C), (xs, 1))
            y = torch.nn.functional.layer_norm(xv.float(), (C,), w, b, LN_EPS)
            ov = _view(*out, (rows, C), (os_, 1))
            ov.copy_(_act(y, ACT_GELU, ov.dtype) if gelu else y)
        self._add(OP_LAYERNORM, [rows, C, xs, os_, _isbf(out), int(gelu)],
                  [x, out, (w, 0), (b, 0), res], [LN_EPS], emu)

    def softmax_rows(self, x, out, rows, n, rowsum=None):
        """out[r] = softmax(x[r]) over n contiguous float32 entries, written
        in out's dtype; rowsum[r] = the sum of the float32 probabilities."""
        def emu():
            p = _softmax(_view(*x, (rows, n), (n, 1)))
            _view(*out, (rows, n), (n, 1)).copy_(p)
            if rowsum is not None:
                _view(*rowsum, (rows,), (1,)).copy_(p.sum(-1))
        self._add(OP_SOFTMAX_ROWS, [rows, n, _isbf(out)], [x, out, rowsum], [], emu)

    def softmax_cols(self, x, out, Z, H, N, L, oz):
        """x (Z, H, N, L) float32; out[z, h*N + t, l] (z stride oz, row
        stride L) = softmax over t, in out's dtype."""
        def emu():
            p = _softmax(_view(*x, (Z, H, N, L), (H * N * L, N * L, L, 1)), 2)
            _view(*out, (Z, H, N, L), (oz, N * L, L, 1)).copy_(p)
        self._add(OP_SOFTMAX_COLS, [Z, H, N, L, oz, _isbf(out)], [x, out], [], emu)

    def bd(self, x, out, Z, T, I, nh, scale):
        """x (Z, T, I) -> out (Z, nh*T, I) head-block-diagonal, entries
        round(x * scale) (scale 0: copied)."""
        def emu():
            xv = _view(*x, (Z, T, I), (T * I, I, 1))
            if scale:
                xv = xv * torch.tensor(scale, dtype=xv.dtype, device=xv.device)
            _view(*out, (Z, nh * T, I), (nh * T * I, I, 1)).copy_(_bd(xv, nh))
        self._add(OP_BD, [Z, T, I, nh, _isbf(out)], [x, out], [scale], emu)

    def head_extract(self, o, out, Z, T, I, nh):
        def emu():
            ov = _view(*o, (Z, nh * T, I), (nh * T * I, I, 1))
            _view(*out, (Z, T, I), (T * I, I, 1)).copy_(_head_extract(ov, T, nh))
        self._add(OP_HEAD_EXTRACT, [Z, T, I, nh, _isbf(out)], [o, out], [], emu)

    def colscale_round(self, x, v, out, Z, M, L):
        """out (Z, M, L) = round(x * v[z, l]); x float32, v (Z, L) float32."""
        def emu():
            xv = _view(*x, (Z, M, L), (M * L, L, 1))
            _view(*out, (Z, M, L), (M * L, L, 1)).copy_(xv * _view(*v, (Z, 1, L), (L, 0, 1)))
        self._add(OP_COLSCALE_ROUND, [Z, M, L, _isbf(out)], [x, v, out], [], emu)

    def cast(self, x, out, n):
        def emu():
            _view(*out, (n,), (1,)).copy_(_view(*x, (n,), (1,)))
        self._add(OP_CAST, [n, _isbf(out)], [x, out], [], emu)

    def setrows(self, buf, Z, zs, n, r0, nrows, vec=None, value=0.0):
        """Rows r0 .. r0+nrows-1 (n elements each) of every z: round(vec) or value."""
        def emu():
            bv = _view(buf[0], buf[1] + r0 * n, (Z, nrows, n), (zs, n, 1))
            bv.copy_((vec if vec is not None else torch.full((n,), value, device=bv.device))
                     .expand(Z, nrows, n))
        self._add(OP_SETROWS, [Z, zs, n, r0, nrows, _isbf(buf)],
                  [(buf[0], buf[1] + r0 * n), (vec, 0)], [value], emu)

    def bprep(self, bbar, sig, bmean, Z, zs, R, C, sigma, scale, bias):
        """From Bbar (rows 0..R-1 of a buffer with z stride zs): sig = round(Bbar
        * sigma) (Z, R, C), bmean = rowsum(Bbar) / C (Z, R); then in place
        Bbar <- [round(Bbar * scale); round(scale); round(bias)] (R + 2 rows)."""
        def emu():
            bv = _view(*bbar, (Z, R + 2, C), (zs, C, 1))
            bf = bv[:, :R].float()
            _view(*sig, (Z, R, C), (R * C, C, 1)).copy_(bf * sigma)
            _view(*bmean, (Z, R), (R, 1)).copy_(bf.sum(-1) / C)
            bv[:, :R].copy_(bf * scale)
            bv[:, R].copy_(scale.expand(Z, C))
            bv[:, R + 1].copy_(bias.expand(Z, C))
        self._add(OP_BPREP, [Z, zs, R, C, _isbf(bbar)],
                  [bbar, sig, bmean, (sigma, 0), (scale, 0), (bias, 0)], [], emu)

    def norm4(self, x1, x2, abuf, bmean, rho, m, q, Z, zs, R, L, C):
        """Closed-form norm4 per column l: from Abar (rows 0..R-1 of abuf),
        X1 = sig @ base^T and X2 = round(gram) @ Abar (Z, R, L float32):
        mu, E[x^2], inv = rsqrt(var + eps); then in place abuf <- [round(Abar
        * round(inv)); round(-inv * mu); 1] and rho <- rho * inv."""
        def emu():
            _norm4_apply(_view(*x1, (Z, R, L), (R * L, L, 1)), _view(*x2, (Z, R, L), (R * L, L, 1)),
                         abuf, bmean, rho, m, q, Z, zs, R, L, C)
        self._add(OP_NORM4, [Z, zs, R, L, C, _isbf(abuf)],
                  [x1, x2, abuf, bmean, rho, (m, 0), (q, 0)], [LN_EPS], emu)

    # -- the fused records of the bf16 route (csrc/factored_fused.cuh) --------

    def t2i(self, qbd, G, Gv, o, Z, M, Ci, L, nh, *, PE=None, qbw=None, abuf=None, zs=0, R=0,
            rsb=None, rho=None, pa=None, rs=None):
        """Token-to-image attention over L, fused: per prompt z the scores
        s = rho (x) (qbd G^T) + qbw A + qbd PE^T + rsb (M x L, float32; each
        term only where given, A = rows 0..R-1 of abuf with z stride zs), p =
        softmax(s) over L, then o = round(p * rho) Gv (float32), pa =
        round(round(p) A^T) (M x R, bf16) and rs = rowsum(p).  qbd (Z, M,
        Ci), G, PE, Gv (L, Ci) shared by every z.  The kernel keeps s and p
        out of device memory: two sweeps over L (the row statistics, then p
        and the products), L split across CTAs, the partials combined in a
        fixed order in float32 scratch of its own."""
        dev = qbd[0].device
        sms = torch.cuda.get_device_properties(dev).multi_processor_count \
            if dev.type == "cuda" else 132
        # room for up to two waves of CTAs' splits of L; the kernel takes one
        ns = max(1, min(L // FUSED_TILE, 2 * sms // Z))
        # scratch: the row statistics (two slots a split), partial o, pa, rs
        sizes = [Z * ns * 2 * 64 * 2, Z * ns * 64 * Ci, Z * ns * 64 * R, Z * ns * 64]
        scratch = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
        offs = [sum(sizes[:i]) for i in range(4)]
        # the useful operations of the unfused records (qbd holds Ci / nh
        # nonzeros a row): the scores against G (and PE, and A), p Gv, p A^T
        self.flops += 2.0 * Z * M * L * (Ci / nh * (2 if PE is None else 3) + 2 * R)

        def emu():
            q = _view(*qbd, (Z, M, Ci), (M * Ci, Ci, 1)).float()
            av = _view(*abuf, (Z, R, L), (zs, L, 1)).float() if R else None
            rv = _view(*rho, (Z, 1, L), (L, L, 1)) if rho is not None else None
            s = _fact_scores(q, G, PE, qbw, av, rsb, rv, Z, M, R)
            p = _softmax(s)
            dt = qbd[0].dtype
            pr = (p * rv if rv is not None else p).to(dt).float()
            _view(*o, (Z, M, Ci), (M * Ci, Ci, 1)).copy_(torch.matmul(pr, Gv.float()))
            if R:
                _view(*pa, (Z, M, R), (M * R, R, 1)).copy_(
                    torch.matmul(p.to(dt).float(), av.transpose(1, 2)))
            if rs is not None:
                _view(*rs, (Z, M), (M, 1)).copy_(p.sum(-1))

        self._add(OP_T2I, [Z, M, Ci, L, R, zs, ns, *offs],
                  [qbd, (G, 0), (PE, 0), qbw, abuf, rsb, rho, (Gv, 0), o, pa, rs, (scratch, 0)],
                  [], emu)

    def i2t(self, kbd, G, out, Z, M, Ci, L, nh, oz, *, PE=None, qbw=None, abuf=None, zs=0,
            R=0, rsb=None, rho=None):
        """Image-to-token scores and the rank update, fused: s as
        :meth:`t2i`'s, then a softmax over each head's M / nh token rows per
        column l, written as rows of out (z stride oz, row stride L) in its
        dtype; s never reaches device memory."""
        N = M // nh
        self.flops += 2.0 * Z * M * L * (Ci / nh * (1 if PE is None else 2) + R)

        def emu():
            q = _view(*kbd, (Z, M, Ci), (M * Ci, Ci, 1)).float()
            av = _view(*abuf, (Z, R, L), (zs, L, 1)).float() if R else None
            rv = _view(*rho, (Z, 1, L), (L, L, 1)) if rho is not None else None
            s = _fact_scores(q, G, PE, qbw, av, rsb, rv, Z, M, R)
            p = _softmax(s.reshape(Z, nh, N, L), 2)
            _view(*out, (Z, nh, N, L), (oz, N * L, L, 1)).copy_(p)

        self._add(OP_I2T, [Z, M, Ci, L, R, zs, nh, oz],
                  [kbd, (G, 0), (PE, 0), qbw, abuf, rsb, rho, out], [], emu)

    def norm4_fused(self, sig, base, gram, abuf, bmean, rho, m, q, Z, zs, R, L, C, gs):
        """:meth:`norm4` with its two products fused in: X1 = sig (Z, R, C)
        @ base (L, C)^T and X2 = gram (Z, R, gs: R columns used) @ Abar are
        computed a tile of columns at a time and never reach device memory."""
        self.flops += 2.0 * Z * R * L * (C + R)

        def emu():
            x1 = torch.matmul(_view(*sig, (Z, R, C), (R * C, C, 1)).float(), base.float().t())
            gv = _view(*gram, (Z, R, R), (R * gs, gs, 1)).float()
            x2 = torch.matmul(gv, _view(*abuf, (Z, R, L), (zs, L, 1)).float())
            _norm4_apply(x1, x2, abuf, bmean, rho, m, q, Z, zs, R, L, C)

        self._add(OP_NORM4_FUSED, [Z, zs, R, L, C, gs],
                  [sig, (base, 0), gram, abuf, bmean, rho, (m, 0), (q, 0)], [LN_EPS], emu)

    def upscale(self, abuf, bw1, rho, Gc1, b1, ln, w2, b2, hbd, cols, Z, zs, R, L, nt):
        """The upscale tail, fused, per 64 rows of L: y1 = round(A^T bw1 +
        Gc1 * rho + b1) (L x 4 co1), then for each sub-pixel group g: z =
        round(gelu(round(LN(y1[:, g co1 ..])))), z2 = round(gelu(round(z w2
        + b2))), cols[:, 4 nt g ..] = round(z2 hbd^T).  bw1 (Z, R, 4 co1),
        Gc1 (L, 4 co1), w2 (co1, 4 co2), hbd (Z, 4 nt, 4 co2); only the
        mask columns (Z, L, 16 nt) reach device memory."""
        c4 = bw1[0].shape[-1]
        co1, w4 = c4 // 4, w2.shape[1]
        self.flops += 2.0 * Z * L * (R * c4 + 4 * co1 * w4 + 4 * w4 * 4 * nt / 4)

        def emu():
            dt = cols[0].dtype
            av = _view(*abuf, (Z, R, L), (zs, L, 1)).float()
            y = torch.matmul(av.transpose(1, 2), _view(*bw1, (Z, R, c4), (R * c4, c4, 1)).float())
            y = Gc1.float()[None] * _view(*rho, (Z, L, 1), (L, 1, 0)) + y
            y1 = (y + b1).to(dt).float()
            hb = _view(*hbd, (Z, 4 * nt, w4), (4 * nt * w4, w4, 1)).float()
            cv = _view(*cols, (Z, L, 16 * nt), (L * 16 * nt, 16 * nt, 1))
            for g1 in range(4):
                z = torch.nn.functional.layer_norm(y1[..., g1 * co1:(g1 + 1) * co1], (co1,),
                                                   ln.weight.float(), ln.bias.float(), LN_EPS)
                z = _act(z, ACT_GELU, dt).to(dt).float()
                z2 = _act(torch.matmul(z, w2.float()) + b2, ACT_GELU, dt).to(dt).float()
                cv[..., g1 * 4 * nt:(g1 + 1) * 4 * nt].copy_(torch.matmul(z2, hb.transpose(1, 2)))

        self._add(OP_UPSCALE, [Z, zs, R, L, c4, w4, 4 * nt],
                  [abuf, bw1, rho, (Gc1, 0), (b1, 0), (ln.weight.float(), 0), (ln.bias.float(), 0),
                   (w2, 0), (b2, 0), hbd, cols], [LN_EPS], emu)

    def hbd(self, hyper, out, Z, nt, co2):
        def emu():
            hv = _view(*hyper, (Z, nt, co2), (nt * co2, co2, 1))
            _view(*out, (Z, 4 * nt, 4 * co2), (16 * nt * co2, 4 * co2, 1)).copy_(_hbd(hv))
        self._add(OP_HBD, [Z, nt, co2, _isbf(out)], [hyper, out], [], emu)

    # -- execution -----------------------------------------------------------

    def run_torch(self) -> None:
        """Interpret the records with torch, in order."""
        for rec in self.records:
            rec[4]()

    def pack(self):
        """The records as the C side reads them: int64 (n, N_INTS), pointers
        (n, N_PTRS) and float32 (n, N_FLOATS) arrays, and the op codes."""
        n = len(self.records)
        ints = (ctypes.c_longlong * (n * N_INTS))()
        ptrs = (ctypes.c_void_p * (n * N_PTRS))()
        floats = (ctypes.c_float * (n * N_FLOATS))()
        ops = (ctypes.c_int * n)()
        for i, (op, iv, pv, fv, _) in enumerate(self.records):
            ops[i] = op
            for j, x in enumerate(iv):
                ints[i * N_INTS + j] = int(x)
            for j, opnd in enumerate(pv):
                if opnd is not None and opnd[0] is not None:
                    t, off = opnd
                    ptrs[i * N_PTRS + j] = t.data_ptr() + off * t.element_size()
            for j, x in enumerate(fv):
                floats[i * N_FLOATS + j] = float(x)
        return n, ops, ints, ptrs, floats


def _isbf(opnd) -> int:
    return int(opnd[0].dtype == torch.bfloat16)


def _scale_in(dt, hd: int) -> float:
    """1/sqrt(hd) rounded to dt, as the JAX package multiplies in q's dtype."""
    return float(torch.tensor(1.0 / math.sqrt(hd), dtype=dt))


def g_program(twt, decoder, image_embedding, image_pe, tokens, num_heads: int,
              fused=None):
    """Kernel G's launch sequence for one chunk of prompts sharing one base.
    Returns (program, mask columns (P, L, 16*nt), iou (P, 1, nt)); the two
    outputs are filled when the program runs.

    Routes by dtype (``fused`` None): bf16 records the four parts that sweep
    over L (FUSED_PARTS) as fused records (:meth:`Program.t2i`,
    :meth:`Program.i2t`, :meth:`Program.norm4_fused`,
    :meth:`Program.upscale`), which keep the float32 scores, norm4's
    products and the upscale's intermediates out of device memory; float32
    records the unfused sequence of GEMMs, softmaxes, LayerNorms and norm4
    (the fused kernels are bf16 only).  The token-side records are the same
    on both routes.  ``fused``, a collection of parts (or True / False for
    all / none), overrides the route, for the CPU tests."""
    _, Hs, Ws, C = image_embedding.shape
    L = Hs * Ws
    dt, dev = image_embedding.dtype, image_embedding.device
    base = image_embedding.reshape(L, C).contiguous()
    head = decode_head_params(decoder)
    w1, b1 = (t.contiguous() for t in head["conv1"])
    w2, b2 = (t.contiguous() for t in head["conv2"])
    sh = factored_shared(twt, base, image_pe.reshape(-1, L, C)[0], w1.to(dt))
    tokens = tokens.to(dt).contiguous()
    P, N, _ = tokens.shape
    nh = num_heads
    M = nh * N
    f32 = torch.float32
    if fused is None:
        fused = dt == torch.bfloat16
    fused = set(FUSED_PARTS) if fused is True else set(fused or ())
    prog = Program()

    def new(*shape, dtype=dt):
        return torch.empty(shape, dtype=dtype, device=dev)

    def dense(lin, x, M_, out, *, xz, xm, oz, om, act=ACT_NONE):
        K, Nn = lin.in_features, lin.out_features
        prog.gemm(x, (lin.weight, 0), out, P, M_, Nn, K, (xz, xm, 1), (0, 1, K), (oz, om, 1),
                  bias=lin.bias.float(), act=act)

    def tok_dense(lin, x):   # (P, N, in) contiguous -> (P, N, out)
        out = new(P, N, lin.out_features)
        dense(lin, (x, 0), N, (out, 0), xz=N * lin.in_features, xm=lin.in_features,
              oz=N * lin.out_features, om=lin.out_features)
        return out

    def add(x, y):
        out = new(*x.shape)
        prog.add((x, 0), (y, 0), (out, 0), x.numel())
        return out

    def norm(ln, x, res=None):
        out = new(*x.shape)
        prog.layernorm((x, 0), (out, 0), x.numel() // C, C, C, C, ln.weight.float(),
                       ln.bias.float(), res=None if res is None else (res, 0))
        return out

    def bd(x, scaled):
        I = x.shape[-1]
        out = new(P, nh * N, I)
        prog.bd((x, 0), (out, 0), P, N, I, nh, _scale_in(dt, I // nh) if scaled else 0.0)
        return out

    def head_out(lin, o):   # (P, M, I) float32 -> dense(out, head_extract(o))
        I = o.shape[-1]
        ext = new(P, N, I)
        prog.head_extract((o, 0), (ext, 0), P, N, I, nh)
        return tok_dense(lin, ext)

    def self_attn(p, q, v):
        qh, kh, vh = tok_dense(p.q, q), tok_dense(p.k, q), tok_dense(p.v, v)
        I = qh.shape[-1]
        qbd = bd(qh, True)
        s = new(P, M, N, dtype=f32)
        prog.gemm((qbd, 0), (kh, 0), (s, 0), P, M, N, I, (M * I, I, 1), (N * I, 1, I),
                  (M * N, N, 1), useful=1 / nh)
        pr = new(P, M, N)
        prog.softmax_rows((s, 0), (pr, 0), P * M, N)
        o = new(P, M, I, dtype=f32)
        prog.gemm((pr, 0), (vh, 0), (o, 0), P, M, I, N, (M * N, N, 1), (N * I, I, 1),
                  (M * I, I, 1), useful=1 / nh)
        return head_out(p.out, o)

    # the rank state: A (P, Rmax, L), B (P, Rmax, C), rho (P, L)
    R_prev, sizes = 0, []
    for _ in twt.layers:
        rab = R_prev + M + 1
        rab += _pad_rows(rab)
        sizes.append(rab)
        R_prev = rab + 2
    Rmax = R_prev
    A, Bm = new(P, Rmax, L), new(P, Rmax, C)
    rho = new(P, L, dtype=f32)
    prog.setrows((rho, 0), P, L, L, 0, 1, value=1.0)   # norm4 scales rho in place
    Ci = twt.layers[0].cross_attn_t2i.q.out_features

    def score_terms(qbd, lin, R):
        """qbw = qbd (B W)^T (P, M, R) and rsb = qbd b (P, M), the small
        products of the scores' rank and bias terms."""
        bw = new(P, R, Ci)
        prog.gemm((Bm, 0), (lin.weight, 0), (bw, 0), P, R, Ci, C, (Rmax * C, C, 1),
                  (0, 1, C), (R * Ci, Ci, 1))
        qbw = new(P, M, R)
        prog.gemm((qbd, 0), (bw, 0), (qbw, 0), P, M, R, Ci, (M * Ci, Ci, 1),
                  (R * Ci, 1, Ci), (M * R, R, 1), useful=1 / nh)
        rsb = new(P, M, dtype=f32)
        prog.gemm((qbd, 0), (lin.bias.float(), 0), (rsb, 0), P, M, 1, Ci, (M * Ci, Ci, 1),
                  (0, 1, 0), (M, 1, 1), useful=1 / nh)
        return qbw, rsb

    def rank_terms(qbd, lin, R):   # the fused records' keyword arguments
        qbw, rsb = score_terms(qbd, lin, R)
        return dict(qbw=(qbw, 0), abuf=(A, 0), zs=Rmax * L, R=R, rsb=(rsb, 0), rho=(rho, 0))

    def proj_scores(qbd, G, PE, lin, s, R):
        prog.gemm((qbd, 0), (G, 0), (s, 0), P, M, L, Ci, (M * Ci, Ci, 1), (0, 1, Ci),
                  (M * L, L, 1), colscale=(rho, L), useful=1 / nh)
        qbw, rsb = score_terms(qbd, lin, R)
        prog.gemm((qbw, 0), (A, 0), (s, 0), P, M, L, R, (M * R, R, 1), (Rmax * L, L, 1),
                  (M * L, L, 1), beta=(s, 0))
        prog.gemm((qbd, 0), (PE, 0), (s, 0), P, M, L, Ci, (M * Ci, Ci, 1), (0, 1, Ci),
                  (M * L, L, 1), beta=(s, 0), rowadd=(rsb, M), useful=1 / nh)

    def value_terms(o, pa, rs, lin, R):   # o += pa (B Wv) + rs (x) bv
        bw = new(P, R, Ci)
        prog.gemm((Bm, 0), (lin.weight, 0), (bw, 0), P, R, Ci, C, (Rmax * C, C, 1),
                  (0, 1, C), (R * Ci, Ci, 1))
        prog.gemm((pa, 0), (bw, 0), (o, 0), P, M, Ci, R, (M * R, R, 1), (R * Ci, Ci, 1),
                  (M * Ci, Ci, 1), beta=(o, 0), rowadd=(rs, M), bias=lin.bias.float(),
                  outer=True, useful=1 / nh)

    def attend_v(probs, rs, Gv, lin, R):
        pr = new(P, M, L)
        prog.colscale_round((probs, 0), (rho, 0), (pr, 0), P, M, L)
        o = new(P, M, Ci, dtype=f32)
        prog.gemm((pr, 0), (Gv, 0), (o, 0), P, M, Ci, L, (M * L, L, 1), (0, Ci, 1),
                  (M * Ci, Ci, 1), useful=1 / nh)
        pdt = new(P, M, L)
        prog.cast((probs, 0), (pdt, 0), P * M * L)
        pa = new(P, M, R)
        prog.gemm((pdt, 0), (A, 0), (pa, 0), P, M, R, L, (M * L, L, 1), (Rmax * L, 1, L),
                  (M * R, R, 1))
        value_terms(o, pa, rs, lin, R)
        return o

    def scores_softmax(qbd, G, PE, lin, R):
        s = new(P, M, L, dtype=f32)
        proj_scores(qbd, G, PE, lin, s, R)
        probs, rs = new(P, M, L, dtype=f32), new(P, M, dtype=f32)
        prog.softmax_rows((s, 0), (probs, 0), P * M, L, rowsum=(rs, 0))
        return probs, rs

    def attention(qbd, G, PE, lin_k, Gv, lin_v, R):
        """Token-to-image attention against the factored keys state: (P, M,
        Ci) float32 before the head extraction."""
        if "t2i" not in fused:
            probs, rs = scores_softmax(qbd, G, PE, lin_k, R)
            return attend_v(probs, rs, Gv, lin_v, R)
        o, pa, rs = new(P, M, Ci, dtype=f32), new(P, M, R), new(P, M, dtype=f32)
        prog.t2i((qbd, 0), G, Gv, (o, 0), P, M, Ci, L, nh, PE=PE, pa=(pa, 0), rs=(rs, 0),
                 **rank_terms(qbd, lin_k, R))
        value_terms(o, pa, rs, lin_v, R)
        return o

    qpe = queries = tokens
    sigma = torch.ones(C, device=dev)
    R = 0
    for i, p in enumerate(twt.layers):
        if i == 0:
            queries = norm(p.norm1, self_attn(p.self_attn, queries, queries))
        else:
            q = add(queries, qpe)
            queries = norm(p.norm1, queries, self_attn(p.self_attn, q, queries))

        ca = p.cross_attn_t2i
        qbd = bd(tok_dense(ca.q, add(queries, qpe)), True)
        prog.region = "t2i"
        if i == 0 and "t2i" in fused:
            o = new(P, M, Ci, dtype=f32)
            prog.t2i((qbd, 0), sh["kh1"], sh["vh1"], (o, 0), P, M, Ci, L, nh)
        elif i == 0:
            s = new(P, M, L, dtype=f32)
            prog.gemm((qbd, 0), (sh["kh1"], 0), (s, 0), P, M, L, Ci, (M * Ci, Ci, 1),
                      (0, 1, Ci), (M * L, L, 1), useful=1 / nh)
            pr = new(P, M, L)
            prog.softmax_rows((s, 0), (pr, 0), P * M, L)
            o = new(P, M, Ci, dtype=f32)
            prog.gemm((pr, 0), (sh["vh1"], 0), (o, 0), P, M, Ci, L, (M * L, L, 1),
                      (0, Ci, 1), (M * Ci, Ci, 1), useful=1 / nh)
        else:
            blk = sh["blocks"][i - 1]
            o = attention(qbd, blk["Gk"], blk["PEk"], ca.k, blk["Gv"], ca.v, R)
        prog.region = "token"
        queries = norm(p.norm2, queries, head_out(ca.out, o))
        h = new(P, N, p.mlp.fc1.out_features)
        dense(p.mlp.fc1, (queries, 0), N, (h, 0), xz=N * C, xm=C, oz=h[0].numel(),
              om=h.shape[-1], act=ACT_RELU)
        queries = norm(p.norm3, queries, tok_dense(p.mlp.fc2, h))

        ia = p.cross_attn_i2t
        kbd = bd(tok_dense(ia.k, add(queries, qpe)), True)
        vbd = bd(tok_dense(ia.v, queries), False)
        prog.region = "i2t"
        if "i2t" in fused:   # the scores and their column softmax straight into A's rows
            if i == 0:
                prog.i2t((kbd, 0), sh["qi1"], (A, R * L), P, M, Ci, L, nh, Rmax * L)
            else:
                blk = sh["blocks"][i - 1]
                prog.i2t((kbd, 0), blk["Gq"], (A, R * L), P, M, Ci, L, nh, Rmax * L,
                         PE=blk["PEq"], **rank_terms(kbd, ia.q, R))
        else:
            s = new(P, M, L, dtype=f32)
            if i == 0:
                prog.gemm((kbd, 0), (sh["qi1"], 0), (s, 0), P, M, L, Ci, (M * Ci, Ci, 1),
                          (0, 1, Ci), (M * L, L, 1), useful=1 / nh)
            else:
                blk = sh["blocks"][i - 1]
                proj_scores(kbd, blk["Gq"], blk["PEq"], ia.q, s, R)
            prog.softmax_cols((s, 0), (A, R * L), P, nh, N, L, Rmax * L)
        prog.gemm((vbd, 0), (ia.out.weight, 0), (Bm, R * C), P, M, C, Ci, (M * Ci, Ci, 1),
                  (0, 1, Ci), (Rmax * C, C, 1), useful=1 / nh)
        rab = sizes[i]
        prog.setrows((A, 0), P, Rmax * L, L, R + M, 1, value=1.0)
        prog.setrows((Bm, 0), P, Rmax * C, C, R + M, 1, vec=ia.out.bias.float())
        if rab > R + M + 1:
            prog.setrows((A, 0), P, Rmax * L, L, R + M + 1, rab - R - M - 1)
            prog.setrows((Bm, 0), P, Rmax * C, C, R + M + 1, rab - R - M - 1)
        prog.region = "norm4"
        rs8 = -(-rab // 8) * 8   # gram's row stride: a multiple of 8, for 16-byte copies
        gram = new(P, rab, rs8)
        prog.gemm((Bm, 0), (Bm, 0), (gram, 0), P, rab, rab, C, (Rmax * C, C, 1),
                  (Rmax * C, 1, C), (rab * rs8, rs8, 1))
        sig, bmean = new(P, rab, C), new(P, rab, dtype=f32)
        prog.bprep((Bm, 0), (sig, 0), (bmean, 0), P, Rmax * C, rab, C, sigma,
                   p.norm4.weight.float(), p.norm4.bias.float())
        if "norm4" in fused:
            prog.norm4_fused((sig, 0), base, (gram, 0), (A, 0), (bmean, 0), (rho, 0),
                             sh["stats_m"][i], sh["stats_q"][i], P, Rmax * L, rab, L, C, rs8)
        else:
            x1, x2 = new(P, rab, L, dtype=f32), new(P, rab, L, dtype=f32)
            prog.gemm((sig, 0), (base, 0), (x1, 0), P, rab, L, C, (rab * C, C, 1), (0, 1, C),
                      (rab * L, L, 1))
            prog.gemm((gram, 0), (A, 0), (x2, 0), P, rab, L, rab, (rab * rs8, rs8, 1),
                      (Rmax * L, L, 1), (rab * L, L, 1))
            prog.norm4((x1, 0), (x2, 0), (A, 0), (bmean, 0), (rho, 0), sh["stats_m"][i],
                       sh["stats_q"][i], P, Rmax * L, rab, L, C)
        sigma = sigma * p.norm4.weight.float()
        R = rab + 2
        prog.region = "token"

    fa = twt.final_attn
    qbd = bd(tok_dense(fa.q, add(queries, qpe)), True)
    prog.region = "t2i"
    o = attention(qbd, sh["Gkf"], sh["PEkf"], fa.k, sh["Gvf"], fa.v, R)
    prog.region = "token"
    queries = norm(twt.norm_final, queries, head_out(fa.out, o))

    # the tail: IoU head, hypernetwork MLPs, upscale in the permuted layout
    def mlp_row(stack, row, out, ooff, oz):
        x, xoff, xz, xm = queries, row * C, N * C, C
        n = len(stack.layers)
        for j, lin in enumerate(stack.layers):
            last = j == n - 1
            y = out if last else new(P, 1, lin.out_features)
            dense(lin, (x, xoff), 1, (y, ooff if last else 0), xz=xz, xm=xm,
                  oz=oz if last else lin.out_features, om=lin.out_features,
                  act=ACT_NONE if last else ACT_RELU)
            x, xoff, xz, xm = y, 0, lin.out_features, lin.out_features

    nt = len(head["hyper"])
    iou = new(P, 1, nt)
    mlp_row(head["iou"], 0, iou, 0, nt)
    co2 = w2.shape[1] // 4
    hyper = new(P, nt, co2)
    for n in range(nt):
        mlp_row(head["hyper"][n], 1 + n, hyper, n * co2, nt * co2)
    hbd = new(P, 4 * nt, 4 * co2)
    prog.hbd((hyper, 0), (hbd, 0), P, nt, co2)
    c4 = w1.shape[1]
    co1 = c4 // 4
    prog.region = "upscale"
    bw1 = new(P, R, c4)
    prog.gemm((Bm, 0), (w1.to(dt), 0), (bw1, 0), P, R, c4, C, (Rmax * C, C, 1), (0, c4, 1),
              (R * c4, c4, 1))
    cols = new(P, L, 16 * nt)
    ln = head["ln"]
    if "upscale" in fused:
        prog.upscale((A, 0), (bw1, 0), (rho, 0), sh["Gc1"], b1.float(), ln, w2.to(dt),
                     b2.float(), (hbd, 0), (cols, 0), P, Rmax * L, R, L, nt)
        return prog, cols, iou
    y1 = new(P, L, c4)
    prog.gemm((A, 0), (bw1, 0), (y1, 0), P, L, c4, R, (Rmax * L, 1, L), (R * c4, c4, 1),
              (L * c4, c4, 1), rowadd=(rho, L), rowmat=(sh["Gc1"], c4), bias=b1.float())
    for g1 in range(4):
        z = new(P, L, co1)
        prog.layernorm((y1, g1 * co1), (z, 0), P * L, co1, c4, co1, ln.weight.float(),
                       ln.bias.float(), gelu=True)
        z2 = new(P, L, 4 * co2)
        prog.gemm((z, 0), (w2.to(dt), 0), (z2, 0), P, L, 4 * co2, co1, (L * co1, co1, 1),
                  (0, 4 * co2, 1), (L * 4 * co2, 4 * co2, 1), bias=b2.float(), act=ACT_GELU)
        prog.gemm((z2, 0), (hbd, 0), (cols, g1 * 4 * nt), P, L, 4 * nt, 4 * co2,
                  (L * 4 * co2, 4 * co2, 1), (16 * nt * co2, 1, 4 * co2), (L * 16 * nt, 16 * nt, 1),
                  useful=1 / 4)
    return prog, cols, iou


def launch_records(packed, first: int = 0, stop: Optional[int] = None) -> None:
    """Kernel G on records first .. stop - 1 (all by default) of a packed
    sequence (:meth:`Program.pack`), in one C call."""
    n, ops, ints, ptrs, floats = packed
    stop = n if stop is None else stop
    try:
        FACTORED_DECODE.launch(stop - first, ctypes.addressof(ops) + 4 * first,
                               ctypes.addressof(ints) + 8 * N_INTS * first,
                               ctypes.addressof(ptrs) + 8 * N_PTRS * first,
                               ctypes.addressof(floats) + 4 * N_FLOATS * first)
    except RuntimeError as e:   # name the record that failed
        i = first + library(FACTORED_DECODE.source).factored_decode_failed_record()
        raise RuntimeError(f"{e} at record {i} ({OP_NAMES[ops[i]]})") from e


# the operands that each fused record writes (indices into its pointers)
FUSED_OUTPUTS = {OP_T2I: (8, 9, 10), OP_I2T: (7,), OP_NORM4_FUSED: (3, 5), OP_UPSCALE: (10,)}


def fused_record_errors(prog: Program) -> List[dict]:
    """Each fused record of a recorded sequence on the card against its
    torch interpretation: the sequence runs on the card up to the record,
    the record runs on the card and then, from the same operands, its emu;
    per record and written operand the largest difference and the largest
    magnitude of the emu's result."""
    packed = prog.pack()
    out, done = [], 0
    for i, rec in enumerate(prog.records):
        if rec[0] not in FUSED_OUTPUTS:
            continue
        launch_records(packed, done, i)
        written = [rec[2][j][0] for j in FUSED_OUTPUTS[rec[0]] if rec[2][j] is not None]
        before = [t.clone() for t in written]
        launch_records(packed, i, i + 1)
        got = [t.clone() for t in written]
        for t, b in zip(written, before):
            t.copy_(b)
        rec[4]()
        errs, refs = [], []
        for g, t, b in zip(got, written, before):
            # the elements either run wrote (the rest of a buffer may hold
            # anything, NaN included)
            bits = {2: torch.int16, 4: torch.int32}[t.element_size()]
            w = (g.view(bits) != b.view(bits)) | (t.view(bits) != b.view(bits))
            errs.append((g.float() - t.float())[w].abs().max().item() if w.any() else 0.0)
            refs.append(t.float()[w].abs().max().item() if w.any() else 0.0)
        out.append({"record": i, "op": OP_NAMES[rec[0]], "max_abs_err": errs,
                    "max_abs_ref": refs})
        done = i + 1
    launch_records(packed, done)
    return out


class _Plan:
    """Kernel G's launch sequence for one shared base, recorded once with a
    token buffer of its own and replayed for every chunk of prompts: the
    shared precomputes, the records and their packing are the same for
    every chunk of an image."""

    def __init__(self, twt, decoder, image_embedding, image_pe, tokens, num_heads: int):
        self.tokens = torch.empty(tokens.shape, dtype=image_embedding.dtype,
                                  device=tokens.device)
        self.prog, self.cols, self.iou = g_program(twt, decoder, image_embedding, image_pe,
                                                   self.tokens, num_heads)
        self.packed = self.prog.pack()
        self.hw = image_embedding.shape[1:3]

    def run(self, tokens: torch.Tensor):
        self.tokens.copy_(tokens)
        launch_records(self.packed)
        P, nt = tokens.shape[0], self.iou.shape[-1]
        # both copies leave the buffers free for the next chunk (same stream)
        return unpermute_masks(self.cols, P, *self.hw, nt), self.iou[:, 0].clone()


def _stamp(t: torch.Tensor) -> tuple:
    # an inference tensor has no version counter: its in-place changes are not seen
    version = -1 if t.is_inference() else t._version
    return t.data_ptr(), version, t.dtype, tuple(t.shape), t.stride()


def cached(cache: Optional[Dict], name: str, inputs, fn, extra=()):
    """``fn(*inputs)``, kept in ``cache[name]`` while every input is the
    same tensor, unchanged (same storage, shape and version counter) and
    ``extra`` is equal; anything else computes it anew.  The entry holds the
    inputs, so their storage is not reused by another tensor while it is
    kept.  ``cache`` None: no caching."""
    if cache is None:
        return fn(*inputs)
    key = tuple(_stamp(t) for t in inputs) + tuple(extra)
    hit = cache.get(name)
    if hit is None or hit[0] != key:
        hit = cache[name] = (key, tuple(inputs), fn(*inputs))
    return hit[2]


def factored_decode(twt, decoder, image_embedding, image_pe, tokens, num_heads: int,
                    cache: Optional[Dict] = None):
    """Kernel G wrapper: shapes and result as :func:`factored_decode_plain`.
    A CPU tensor takes the plain version; a CUDA tensor runs the launch
    sequence of :func:`g_program` (bf16 or float32) or raises.  ``cache``, a
    dict kept across calls, keeps the recorded sequence (see :func:`cached`)
    while the base, the positional encoding, the modules and their weights
    and the tokens' shape stay the same, as for the chunks of prompts of one
    image; a change records it anew."""
    if image_embedding.device.type == "cpu":
        return factored_decode_plain(twt, decoder, image_embedding, image_pe, tokens,
                                     num_heads)
    if image_embedding.shape[0] != 1:
        raise ValueError("the factored decode needs a shared base")
    if image_embedding.dtype not in (torch.bfloat16, torch.float32) or not all(
            t.is_cuda for t in (image_pe, tokens)):
        raise ValueError("expected CUDA tensors in bf16 or float32")
    weights = list(twt.parameters()) + list(decoder.parameters())
    plan = cached(cache, "factored_decode", [image_embedding, image_pe] + weights,
                  lambda *_: _Plan(twt, decoder, image_embedding, image_pe, tokens, num_heads),
                  extra=(id(twt), id(decoder), tuple(tokens.shape), num_heads))
    return plan.run(tokens)


# ---------------------------------------------------------------------------
# Kernels H and I: the materialised decode and transformer
# ---------------------------------------------------------------------------

_MODE_TRANSFORMER, _MODE_DECODE = 0, 1   # csrc/twoway_fused.cu
_CROSS_HEAD_DIM, _MAX_TOKENS, _MAX_DEPTH, _MAX_STACK, _MAX_NT, _MAX_CO2 = 16, 16, 8, 8, 8, 32


class _TwOperands:
    """The int64 dims and the pointers of one call of csrc/twoway_fused.cu,
    appended in the order its ``Reader`` reads them.  Float32 copies of the
    biases and norm weights are made here; every tensor is kept until the
    call has been enqueued (later allocations on the stream follow it)."""

    def __init__(self, dtype):
        self.dtype, self.dims, self.ptrs, self.keep = dtype, [], [], []

    def ptr(self, t: Optional[torch.Tensor]) -> None:
        self.keep.append(t)
        self.ptrs.append(None if t is None else t.data_ptr())

    def lin(self, w: torch.Tensor, b: torch.Tensor) -> None:
        """y = x w^T + b, w (out, in)."""
        w = w.detach().to(self.dtype).contiguous()
        self.ptr(w)
        self.ptr(b.detach().float().contiguous())
        self.dims += [w.shape[1], w.shape[0]]

    def linear(self, lin: nn.Linear) -> None:
        self.lin(lin.weight, lin.bias)

    def norm(self, ln) -> None:
        self.ptr(ln.weight.detach().float().contiguous())
        self.ptr(ln.bias.detach().float().contiguous())

    def attn(self, a) -> None:
        for lin in (a.q, a.k, a.v, a.out):
            self.linear(lin)

    def stack(self, st) -> None:
        self.dims.append(len(st.layers))
        for lin in st.layers:
            self.linear(lin)

    def launch(self, kernel: Kernel, mode: int) -> None:
        dims = (ctypes.c_longlong * len(self.dims))(*self.dims)
        ptrs = (ctypes.c_void_p * len(self.ptrs))(*self.ptrs)
        kernel.launch(mode, len(self.dims), ctypes.addressof(dims), len(self.ptrs),
                      ctypes.addressof(ptrs))


def _check_fused(twt, decoder, image_embedding, image_pe, tokens, num_heads: int) -> None:
    """Raise on what kernels H and I do not take."""
    dt = image_embedding.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"expected bf16 or float32, got {dt}")
    if not all(t.is_cuda for t in (image_embedding, image_pe, tokens)):
        raise ValueError("expected CUDA tensors")
    if image_pe.dim() == 4 and image_pe.shape[0] > 1:
        raise ValueError("a per-batch positional encoding is not supported")
    Bi, P, N = image_embedding.shape[0], tokens.shape[0], tokens.shape[1]
    C = image_embedding.shape[-1]
    if Bi not in (1, P):
        raise ValueError(f"image embeddings {Bi} for {P} prompts")
    mods = [twt] if decoder is None else [decoder]
    if any(p.dtype != dt or not p.is_cuda for m in mods for p in m.parameters()):
        raise ValueError(f"the weights must be CUDA tensors in {dt}")
    l0 = twt.layers[0]
    if (l0.cross_attn_t2i.q.out_features != _CROSS_HEAD_DIM * num_heads
            or twt.final_attn.q.out_features != _CROSS_HEAD_DIM * num_heads
            or l0.self_attn.q.out_features % num_heads or N > _MAX_TOKENS
            or C % 8 or C > 1024 or len(twt.layers) > _MAX_DEPTH):
        raise ValueError("unsupported widths: cross-attention heads of 16, at most 16 "
                         "tokens, C a multiple of 8 up to 1024, depth up to 8")
    if decoder is not None:
        stacks = [decoder.iou_head, *decoder.hyper_mlps]
        co2 = decoder.upscale_conv2.weight.shape[0]
        if (len(decoder.hyper_mlps) > _MAX_NT or co2 > _MAX_CO2
                or any(len(st.layers) > _MAX_STACK for st in stacks)):
            raise ValueError("unsupported decoder head: at most 8 mask tokens, "
                             "hypernetwork outputs up to 32, MLPs of up to 8 layers")


def _twoway_fused(mode: int, twt, decoder, image_embedding, image_pe, tokens,
                  num_heads: int):
    """One launch of kernel I (mode 0) or H (mode 1) on CUDA tensors."""
    _check_fused(twt, decoder, image_embedding, image_pe, tokens, num_heads)
    Bi, Hs, Ws, C = image_embedding.shape
    P, N, _ = tokens.shape
    L = Hs * Ws
    dt, dev = image_embedding.dtype, image_embedding.device
    l0 = twt.layers[0]
    Ci, mlp = l0.cross_attn_t2i.q.out_features, l0.mlp.fc1.out_features
    wide = max(C, Ci, l0.self_attn.q.out_features)

    def new(*shape):
        return torch.empty(shape, dtype=dt, device=dev)

    ops = _TwOperands(dt)
    nt = len(decoder.hyper_mlps) if mode == _MODE_DECODE else 0
    ops.dims += [P, N, Hs, Ws, C, num_heads, len(twt.layers), Bi,
                 int(dt == torch.bfloat16), nt]
    if mode == _MODE_DECODE:
        outs = (new(P, nt, 4 * Hs, 4 * Ws), new(P, nt))
    else:
        outs = (new(P, N, C), new(P, L, C))
    for t in (image_embedding.reshape(Bi, L, C).contiguous(),
              image_pe.reshape(-1, L, C)[0].to(dt).contiguous(), tokens.to(dt).contiguous(),
              *outs):
        ops.ptr(t)
    # the keys state (kernel I keeps it in its output), then the scratch
    ops.ptr(new(P, L, C) if mode == _MODE_DECODE else None)
    for shape in ((P, L, C), (P, L, Ci), (P, L, Ci), (P, L, Ci), (P, L, Ci), (P, L, C),
                  (P, N, C), (P, N, C), (P, N, wide), (P, N, wide), (P, N, wide),
                  (P, N, wide), (P, N, C), (P, N, mlp)):
        ops.ptr(new(*shape))
    if mode == _MODE_DECODE:
        w1, b1 = convt_as_matmul(decoder.upscale_conv1)
        w2, b2 = convt_as_matmul(decoder.upscale_conv2)
        co1, co2 = w2.shape[0], w2.shape[1] // 4
        hidden = max(lin.out_features for st in (decoder.iou_head, *decoder.hyper_mlps)
                     for lin in st.layers)
        for shape in ((P, L, w1.shape[1]), (P, L, 4, co1), (P, L, 4, 4 * co2), (P, nt, co2),
                      (P, hidden), (P, hidden)):
            ops.ptr(new(*shape))
    for p in twt.layers:
        ops.attn(p.self_attn)
        ops.norm(p.norm1)
        ops.attn(p.cross_attn_t2i)
        ops.norm(p.norm2)
        ops.linear(p.mlp.fc1)
        ops.linear(p.mlp.fc2)
        ops.norm(p.norm3)
        ops.attn(p.cross_attn_i2t)
        ops.norm(p.norm4)
    ops.attn(twt.final_attn)
    ops.norm(twt.norm_final)
    if mode == _MODE_DECODE:
        ops.lin(w1.t(), b1)
        ops.norm(decoder.upscale_ln)
        ops.lin(w2.t(), b2)
        ops.stack(decoder.iou_head)
        for st in decoder.hyper_mlps:
            ops.stack(st)
    ops.launch(TWOWAY_DECODE if mode == _MODE_DECODE else TWOWAY_TRANSFORMER, mode)
    return outs


def fused_twoway_apply(twt, image_embedding, image_pe, point_embedding, num_heads: int):
    """Kernel I wrapper: shapes and result as :func:`fused_twoway_plain`.  A
    CPU tensor takes the plain version; a CUDA tensor (bf16 or float32)
    launches the kernel or raises."""
    if image_embedding.device.type == "cpu":
        return fused_twoway_plain(twt, image_embedding, image_pe, point_embedding, num_heads)
    if image_embedding.shape[0] != point_embedding.shape[0]:
        raise ValueError("the transformer needs an image embedding per prompt")
    return _twoway_fused(_MODE_TRANSFORMER, twt, None, image_embedding, image_pe,
                         point_embedding, num_heads)


def twoway_decode(twt, decoder, image_embedding, image_pe, tokens, num_heads: int):
    """Kernel H wrapper: shapes and result as :func:`fused_decode_plain`.  A
    CPU tensor takes the plain version; a CUDA tensor (bf16 or float32)
    launches the kernel or raises."""
    if image_embedding.device.type == "cpu":
        return fused_decode_plain(twt, decoder, image_embedding, image_pe, tokens, num_heads)
    return _twoway_fused(_MODE_DECODE, twt, decoder, image_embedding, image_pe, tokens,
                         num_heads)


def fused_decode_apply(twt, decoder, image_embedding, image_pe, point_embedding,
                       num_heads: int, factored: bool = True, cache: Optional[Dict] = None):
    """The fused decode from the transformer onward, routed as the JAX
    function: a shared base (image_embedding (1, S, S, C), more than one
    prompt) with ``factored`` goes to kernel G (``cache`` as
    :func:`factored_decode`); every other case, a base per prompt or a
    shared one with ``factored=False``, to kernel H.  Returns (masks (P,
    nt, 4S, 4S), iou (P, nt)) in the image dtype."""
    if factored and image_embedding.shape[0] == 1 and point_embedding.shape[0] > 1:
        return factored_decode(twt, decoder, image_embedding, image_pe,
                               point_embedding, num_heads, cache=cache)
    return twoway_decode(twt, decoder, image_embedding, image_pe, point_embedding, num_heads)
