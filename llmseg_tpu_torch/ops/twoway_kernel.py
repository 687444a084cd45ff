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
memory.  Their sequence (:func:`tw_program`) is recorded on the same
:class:`Program` and run by the same record interpreter
(``csrc/records.cuh``) from one C call of ``csrc/twoway_fused.cu``; a
plan (:class:`_TwPlan`) records it once for a set of weights and shapes,
with input buffers of its own, and replays it on every call.  In bf16 the
three parts that sweep over L are fused kernels on wgmma and TMA
(``csrc/twoway_sweeps.cuh``) with every keys-side projection folded into
the token side; in float32 the sequence is the strided GEMM and the scalar
attention kernels of ``twoway_fused.cu``.
"""

from __future__ import annotations

import ctypes
import math
import weakref
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

# operation codes of csrc/records.cuh, and the fixed record layout
OP_GEMM, OP_ADD, OP_LAYERNORM, OP_SOFTMAX_ROWS, OP_SOFTMAX_COLS, OP_BD, OP_HEAD_EXTRACT, \
    OP_COLSCALE_ROUND, OP_CAST, OP_SETROWS, OP_BPREP, OP_NORM4, OP_HBD, \
    OP_T2I, OP_I2T, OP_NORM4_FUSED, OP_UPSCALE, \
    OP_TW_ATTN_TOKENS, OP_TW_ATTN_IMAGE, OP_TW_ATTN_ROWS, OP_TW_MASKS, \
    OP_TW_T2I, OP_TW_I2T_NORM4, OP_TW_UPSCALE = range(24)
OP_NAMES = ("gemm", "add", "layernorm", "softmax_rows", "softmax_cols", "bd", "head_extract",
            "colscale_round", "cast", "setrows", "bprep", "norm4", "hbd",
            "t2i", "i2t", "norm4_fused", "upscale",
            "tw_attn_tokens", "tw_attn_image", "tw_attn_rows", "tw_masks",
            "tw_t2i", "tw_i2t_norm4", "tw_upscale")
FUSED_TILE = 64        # the L columns of a fused kernel's tile (csrc/factored_fused.cuh)
FUSED_PARTS = ("t2i", "i2t", "norm4", "upscale")   # the parts with a fused record
N_INTS, N_PTRS, N_FLOATS = 24, 12, 4
# the parts of the decode that g_program tags its records with: token-to-image
# attention, image-to-token scores and the rank update, norm4 with its two
# products, the upscale tail, and the token-side rest
REGIONS = ("t2i", "i2t", "norm4", "upscale", "token")
# tw_program's: the token side, the token-to-image attentions of the layers,
# image-to-token attention with norm4, the final attention, the IoU and
# hypernetwork MLPs, the upscale and the masks
TW_REGIONS = ("token", "t2i", "i2t_norm4", "final", "head", "upscale", "masks")
TW_PARTS = ("t2i", "i2t", "upscale")   # the parts with a fused record (bf16)
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


def _upscale_tail(y, ln, w2, b2, hbd, cols, Z, L, nt) -> None:
    """The upscale tail of :meth:`Program.upscale` and :meth:`Program.tw_upscale`
    from y1 before its rounding (Z, L, 4 co1, float32): per sub-pixel group
    a LayerNorm, GELU, the product with w2 and GELU, then the product with
    the block-diagonal hbd into the mask columns."""
    dt = cols[0].dtype
    co1, w4 = w2.shape
    y1 = y.to(dt).float()
    hb = _view(*hbd, (Z, 4 * nt, w4), (4 * nt * w4, w4, 1)).float()
    cv = _view(*cols, (Z, L, 16 * nt), (L * 16 * nt, 16 * nt, 1))
    for g1 in range(4):
        z = torch.nn.functional.layer_norm(y1[..., g1 * co1:(g1 + 1) * co1], (co1,),
                                           ln.weight.float(), ln.bias.float(), LN_EPS)
        z = _act(z, ACT_GELU, dt).to(dt).float()
        z2 = _act(torch.matmul(z, w2.float()) + b2, ACT_GELU, dt).to(dt).float()
        cv[..., g1 * 4 * nt:(g1 + 1) * 4 * nt].copy_(torch.matmul(z2, hb.transpose(1, 2)))


def _heads_attend(q, k, v, nh: int, scale: float, q_side: bool) -> torch.Tensor:
    """softmax(q k^T) v per head (nh heads of I / nh columns) in float32,
    with q (q_side) or k multiplied by scale and rounded to its dtype first
    and the probabilities rounded to v's: (P, Tq, I) from q (P, Tq, I), k
    and v (P, Tk, I)."""
    dt = q.dtype
    sc = torch.tensor(scale, dtype=torch.float32)
    if q_side:
        q = (q.float() * sc).to(dt)
    else:
        k = (k.float() * sc).to(dt)
    qh, kh, vh = (t.float().unflatten(-1, (nh, -1)).transpose(1, 2) for t in (q, k, v))
    p = _softmax(torch.matmul(qh, kh.transpose(-1, -2))).to(dt).float()
    return torch.matmul(p, vh).transpose(1, 2).flatten(-2)


def _max_splits(L: int, Z: int, dev) -> int:
    """Room for the splits of L of a fused sweep over it: up to two waves
    of CTAs (the kernel takes one, csrc/factored_fused.cuh ``splits``)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count \
        if dev.type == "cuda" else 132
    return max(1, min(L // FUSED_TILE, 2 * sms // Z))


class Program:
    """A recorded sequence of kernel G's, H's or I's operations.  Each
    record keeps its operands (tensor, element offset), its integer and
    float arguments, and a torch interpretation of the same operation."""

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

    def add(self, x, y, out, n, ny=None):
        """out = round(x + y), n contiguous elements of one dtype; y has ny
        (n by default) and repeats (a positional encoding added to every
        prompt's keys)."""
        def emu():
            yv = _view(*y, (ny or n,), (1,)).repeat(n // (ny or n))
            _view(*out, (n,), (1,)).copy_(_view(*x, (n,), (1,)) + yv)
        self._add(OP_ADD, [n, _isbf(out)] + ([ny] if ny else []), [x, y, out], [], emu)

    def layernorm(self, x, out, rows, C, xs, os_, w, b, *, res=None, gelu=False, xrows=None):
        """out[r] = LN(round(x[r] + res[r])) (eps 1e-6, float32 statistics),
        rounded, then tanh-GELU and rounded again with ``gelu``.  Rows of C
        elements with row strides xs (x and res) and os_ (out); C <= 1024.
        ``xrows``: x has that many rows, read modulo xrows (a shared base
        under every prompt's residual)."""
        def emu():
            xv = _view(*x, (xrows or rows, C), (xs, 1)).repeat(rows // (xrows or rows), 1)
            if res is not None:
                xv = xv + _view(*res, (rows, C), (xs, 1))
            y = torch.nn.functional.layer_norm(xv.float(), (C,), w, b, LN_EPS)
            ov = _view(*out, (rows, C), (os_, 1))
            ov.copy_(_act(y, ACT_GELU, ov.dtype) if gelu else y)
        self._add(OP_LAYERNORM, [rows, C, xs, os_, _isbf(out), int(gelu)]
                  + ([xrows] if xrows else []), [x, out, (w, 0), (b, 0), res], [LN_EPS], emu)

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
        ns = _max_splits(L, Z, dev)
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
            av = _view(*abuf, (Z, R, L), (zs, L, 1)).float()
            y = torch.matmul(av.transpose(1, 2), _view(*bw1, (Z, R, c4), (R * c4, c4, 1)).float())
            y = Gc1.float()[None] * _view(*rho, (Z, L, 1), (L, 1, 0)) + y
            _upscale_tail(y + b1, ln, w2, b2, hbd, cols, Z, L, nt)

        self._add(OP_UPSCALE, [Z, zs, R, L, c4, w4, 4 * nt],
                  [abuf, bw1, rho, (Gc1, 0), (b1, 0), (ln.weight.float(), 0), (ln.bias.float(), 0),
                   (w2, 0), (b2, 0), hbd, cols], [LN_EPS], emu)

    # -- kernels H and I: their scalar kernels (csrc/twoway_fused.cu; the
    # token self attention on both routes, the rest on the float32 one) ------

    def tw_attn_tokens(self, q, k, v, out, P, Tq, Tk, I, nh, scale):
        """Attention of Tq rows to Tk keys (Tk <= 16), per prompt and head
        (nh heads of I / nh): s = round(q * scale) k^T in float32, p =
        round(softmax(s)), out = round(p v).  q, out (P, Tq, I); k, v (P,
        Tk, I), all contiguous."""
        def emu():
            qv = _view(*q, (P, Tq, I), (Tq * I, I, 1))
            kv, vv = (_view(*t, (P, Tk, I), (Tk * I, I, 1)) for t in (k, v))
            _view(*out, (P, Tq, I), (Tq * I, I, 1)).copy_(
                _heads_attend(qv, kv, vv, nh, scale, q_side=True))
        self._add(OP_TW_ATTN_TOKENS, [P, Tq, Tk, I, nh, _isbf(out)], [q, k, v, out], [scale],
                  emu)

    def tw_attn_image(self, q, k, v, out, P, Tq, Tk, I, nh, kz, scale):
        """Tq <= 16 prompt rows attending to Tk image keys, nh heads (of 16 on
        the card): as :meth:`tw_attn_tokens`, with k and v (P, Tk, I) of z
        stride kz (0: one set of keys read by every prompt)."""
        self.flops += 4.0 * P * Tq * Tk * I

        def emu():
            qv = _view(*q, (P, Tq, I), (Tq * I, I, 1))
            kv, vv = (_view(*t, (P, Tk, I), (kz, I, 1)) for t in (k, v))
            _view(*out, (P, Tq, I), (Tq * I, I, 1)).copy_(
                _heads_attend(qv, kv, vv, nh, scale, q_side=True))
        self._add(OP_TW_ATTN_IMAGE, [P, Tq, Tk, I, nh, kz, _isbf(out)], [q, k, v, out],
                  [scale], emu)

    def tw_attn_rows(self, q, qz, k, v, out, P, L, Tk, I, nh, scale):
        """L image rows attending to Tk <= 16 prompt tokens, nh heads (of 16
        on the card): s = q round(k * scale)^T in float32, p =
        round(softmax(s)) over the tokens, out = round(p v).  q (P, L, I) of
        z stride qz (0: shared); k, v (P, Tk, I); out (P, L, I) contiguous."""
        self.flops += 4.0 * P * L * Tk * I

        def emu():
            qv = _view(*q, (P, L, I), (qz, I, 1))
            kv, vv = (_view(*t, (P, Tk, I), (Tk * I, I, 1)) for t in (k, v))
            _view(*out, (P, L, I), (L * I, I, 1)).copy_(
                _heads_attend(qv, kv, vv, nh, scale, q_side=False))
        self._add(OP_TW_ATTN_ROWS, [P, L, Tk, I, nh, qz, _isbf(out)], [q, k, v, out], [scale],
                  emu)

    def tw_masks(self, z2, hyper, masks, P, Hs, Ws, nt, co2):
        """The hypernetwork product in the final mask layout: z2 (P, L, 4,
        4 co2) after conv2, columns (g2, c) per group g1 of conv1; hyper (P,
        nt, co2); masks (P, nt, 4 Hs, 4 Ws) = round(z2 hyper^T), pixel (4i +
        2 di1 + di2, 4j + 2 dj1 + dj2) for g = (di, dj)."""
        L = Hs * Ws
        self.flops += 2.0 * P * L * 16 * nt * co2

        def emu():
            zv = _view(*z2, (P, Hs, Ws, 2, 2, 2, 2, co2),
                       (L * 16 * co2, Ws * 16 * co2, 16 * co2, 8 * co2, 4 * co2, 2 * co2, co2, 1))
            hv = _view(*hyper, (P, nt, co2), (nt * co2, co2, 1)).float()
            m = torch.einsum("pijabcdk,ptk->ptiacjbd", zv.float(), hv)
            _view(*masks, (P, nt, 4 * Hs, 4 * Ws),
                  (16 * L * nt, 16 * L, 4 * Ws, 1)).copy_(m.reshape(P, nt, 4 * Hs, 4 * Ws))
        self._add(OP_TW_MASKS, [P, Hs, Ws, nt, co2, _isbf(masks)], [z2, hyper, masks], [], emu)

    # -- kernels H and I: the fused sweeps over L of the bf16 route
    # (csrc/twoway_sweeps.cuh) ------------------------------------------------

    def tw_t2i(self, qk, rsb, keys, kz, pe, pk, rs, Z, M, L, C):
        """Token-to-image attention with the keys-side projections folded
        into the token side: per prompt z, with kpe = round(K[z] + pe), s =
        qk kpe^T + rsb (M x L, float32), p = softmax(s) over L, pk =
        round(round(p) K[z]) (M x C) and rs = rowsum(p).  qk (Z, M, C) =
        round(qbd W_k) and rsb (Z, M) = qbd b_k; K (L, C) rows of z stride kz
        (0: one base under every prompt); pe (L, C).  The value projection,
        pk W_v^T + rs (x) b_v, follows on the token side.  The kernel keeps s
        and p out of device memory: two sweeps over L (the row statistics,
        then p and its products), L split across CTAs, the partials combined
        in a fixed order in float32 scratch of its own."""
        dev = qk[0].device
        nmb = -(-M // FUSED_TILE)
        ns = _max_splits(L, Z * nmb, dev)
        # scratch: the row statistics (two slots a split), partial pk, rs
        sizes = [Z * nmb * ns * 2 * 64 * 2, Z * nmb * ns * 64 * C, Z * nmb * ns * 64]
        scratch = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
        offs = [sum(sizes[:i]) for i in range(3)]
        self.flops += 4.0 * Z * M * L * C

        def emu():
            dt = qk[0].dtype
            kv = _view(*keys, (Z, L, C), (kz, C, 1))
            kpe = (kv + pe).float()
            s = torch.matmul(_view(*qk, (Z, M, C), (M * C, C, 1)).float(), kpe.transpose(1, 2))
            p = _softmax(s + _view(*rsb, (Z, M, 1), (M, 1, 0)))
            _view(*pk, (Z, M, C), (M * C, C, 1)).copy_(torch.matmul(p.to(dt).float(), kv.float()))
            _view(*rs, (Z, M), (M, 1)).copy_(p.sum(-1))

        self._add(OP_TW_T2I, [Z, M, L, C, kz, ns, *offs],
                  [qk, rsb, keys, (pe, 0), pk, rs, (scratch, 0)], [], emu)

    def tw_i2t_norm4(self, keys, kz, pe, kq, kbq, vw, bout, norm, out, Z, Mp, L, C, nh, N):
        """Image-to-token attention and norm4, fused, row-local: per prompt
        z and image row l, with kpe = round(K[z] + pe), s = kpe kq^T + kbq
        (Mp columns, float32), p = round(softmax(s)) over each head's N
        token columns, x = round(K[z] + round(p vw + bout)) and out[z] =
        round(LN(x)) (norm4's weight and bias).  kq (Z, Mp, C) =
        round(kbd W_q), kbq (Z, Mp) = kbd b_q, vw (Z, Mp, C) = round(vbd
        W_out^T), each with the rows of head h at h Np .. h Np + N - 1 (Np =
        Mp / nh; rows t >= N are padding); K as :meth:`tw_t2i`'s; out (Z, L,
        C) contiguous, which may be K itself.  Nothing over L but the new
        keys reaches device memory."""
        Np = Mp // nh
        self.flops += 4.0 * Z * L * nh * N * C   # the padding rows excluded

        def emu():
            dt = out[0].dtype
            kv = _view(*keys, (Z, L, C), (kz, C, 1))
            kpe = (kv + pe).float()
            s = torch.matmul(kpe, _view(*kq, (Z, Mp, C), (Mp * C, C, 1)).float().transpose(1, 2))
            s = (s + _view(*kbq, (Z, 1, Mp), (Mp, 0, 1))).unflatten(-1, (nh, Np))[..., :N]
            p = torch.zeros(Z, L, nh, Np, device=s.device)
            p[..., :N] = _softmax(s)
            vwv = _view(*vw, (Z, Mp, C), (Mp * C, C, 1)).float()
            o = torch.matmul(p.flatten(-2).to(dt).float(), vwv)
            x = kv + (o + bout).to(dt)
            y = torch.nn.functional.layer_norm(x.float(), (C,), norm.weight.float(),
                                               norm.bias.float(), LN_EPS)
            _view(*out, (Z, L, C), (L * C, C, 1)).copy_(y)

        self._add(OP_TW_I2T_NORM4, [Z, Mp, L, C, kz, nh, N],
                  [keys, (pe, 0), kq, kbq, vw, (bout, 0), (norm.weight.float(), 0),
                   (norm.bias.float(), 0), out], [LN_EPS], emu)

    def tw_upscale(self, keys, w1, b1, ln, w2, b2, hbd, cols, Z, L, nt):
        """The upscale from the keys state, per 64 rows of L: y1 = round(K
        w1 + b1) (L x 4 co1), then the tail of :meth:`upscale` (whose code
        the kernel shares): only the mask columns (Z, L, 16 nt) reach
        device memory.  K (Z, L, C), w1 (C, 4 co1), w2 (co1, 4 co2), hbd (Z,
        4 nt, 4 co2)."""
        C, c4 = w1.shape
        co1, w4 = c4 // 4, w2.shape[1]
        self.flops += 2.0 * Z * L * (C * c4 + 4 * co1 * w4 + w4 * 4 * nt)

        def emu():
            y = torch.matmul(_view(*keys, (Z, L, C), (L * C, C, 1)).float(), w1.float())
            _upscale_tail(y + b1, ln, w2, b2, hbd, cols, Z, L, nt)

        self._add(OP_TW_UPSCALE, [Z, L, C, c4, w4, 4 * nt],
                  [keys, (w1, 0), (b1, 0), (ln.weight.float(), 0), (ln.bias.float(), 0),
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


def launch_records(packed, first: int = 0, stop: Optional[int] = None,
                   kernel: Kernel = FACTORED_DECODE) -> None:
    """Records first .. stop - 1 (all by default) of a packed sequence
    (:meth:`Program.pack`) in one C call of ``kernel`` (G's, or H's or I's
    source), counted as one launch of it."""
    n, ops, ints, ptrs, floats = packed
    stop = n if stop is None else stop
    try:
        kernel.launch(stop - first, ctypes.addressof(ops) + 4 * first,
                      ctypes.addressof(ints) + 8 * N_INTS * first,
                      ctypes.addressof(ptrs) + 8 * N_PTRS * first,
                      ctypes.addressof(floats) + 4 * N_FLOATS * first)
    except RuntimeError as e:   # name the record that failed
        i = first + getattr(library(kernel.source), f"{kernel.source}_failed_record")()
        raise RuntimeError(f"{e} at record {i} ({OP_NAMES[ops[i]]})") from e


# the operands that each fused record writes (indices into its pointers)
FUSED_OUTPUTS = {OP_T2I: (8, 9, 10), OP_I2T: (7,), OP_NORM4_FUSED: (3, 5), OP_UPSCALE: (10,),
                 OP_TW_T2I: (4, 5), OP_TW_I2T_NORM4: (8,), OP_TW_UPSCALE: (8,)}


def fused_record_errors(prog: Program, kernel: Kernel = FACTORED_DECODE) -> List[dict]:
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
        launch_records(packed, done, i, kernel)
        written = [rec[2][j][0] for j in FUSED_OUTPUTS[rec[0]] if rec[2][j] is not None]
        before = [t.clone() for t in written]
        launch_records(packed, i, i + 1, kernel)
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
    launch_records(packed, done, None, kernel)
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

_CROSS_HEAD_DIM, _MAX_TOKENS, _MAX_DEPTH, _MAX_STACK, _MAX_NT, _MAX_CO2 = 16, 16, 8, 8, 8, 32


def tw_program(twt, decoder, image_embedding, image_pe, tokens, num_heads: int, fused=None):
    """Kernel H's (``decoder`` given) or I's (``decoder`` None) launch
    sequence, reading image_embedding (Bi, S, S, C), image_pe (L, C) and
    tokens (P, N, C) (contiguous, one dtype) where they lie.  Returns
    (program, outputs), filled when the program runs: H's (masks (P, nt,
    4S, 4S), or mask columns (P, L, 16 nt) in the permuted layout with the
    fused upscale, and iou (P, nt)), I's (queries (P, N, C), keys (P, L, C)).
    The keys state stays materialised, (P, L, C); with a shared base (Bi =
    1) layer 0 reads it for every prompt.

    Routes by dtype (``fused`` None): bf16 records the three parts that
    sweep over L (TW_PARTS) as fused records (:meth:`Program.tw_t2i` for
    every token-to-image attention, :meth:`Program.tw_i2t_norm4`,
    :meth:`Program.tw_upscale`) with every keys-side projection folded into
    the token side; float32 records the unfused sequence: the projections
    over P L rows on the strided GEMM, the scalar attention and mask
    kernels.  Both routes run the token side, (P N, C), on the same
    records.  ``fused``, a collection of parts (or True / False for all /
    none), overrides the route, for the CPU tests and the breakdown."""
    Bi, Hs, Ws, C = image_embedding.shape
    L = Hs * Ws
    P, N, _ = tokens.shape
    dt, dev = image_embedding.dtype, image_embedding.device
    nh = num_heads
    if fused is None:
        fused = dt == torch.bfloat16
    fused = set(TW_PARTS) if fused is True else set(fused or ())
    f32 = torch.float32
    prog = Program()
    l0 = twt.layers[0]
    Ci, Csa = l0.cross_attn_t2i.q.out_features, l0.self_attn.q.out_features
    PN, M = P * N, nh * N
    Np = 8 if N <= 8 else 16       # i2t's token columns a head, padded (fused route)
    base, pe = image_embedding, image_pe
    sc, ssa = _scale_in(dt, Ci // nh), _scale_in(dt, Csa // nh)

    def new(*shape, dtype=dt):
        return torch.empty(shape, dtype=dtype, device=dev)

    pool = {}

    def scratch(slot, *shape):
        """A buffer of the unfused sweeps over L, made once a slot and size
        and shared by every layer: a slot holds one layer's intermediate at
        a time (the records run in order)."""
        key = (slot, math.prod(shape))
        if key not in pool:
            pool[key] = new(key[1])
        return pool[key].view(shape)

    def dense(lin, x, rows, out, *, act=ACT_NONE):
        """rows of out = act(round(x w^T + b)), w = lin's (out, in)."""
        K, Nn = lin.in_features, lin.out_features
        prog.gemm((x, 0), (lin.weight, 0), (out, 0), 1, rows, Nn, K, (0, K, 1), (0, 1, K),
                  (0, Nn, 1), bias=lin.bias.float(), act=act)
        return out

    def tok(lin, x, act=ACT_NONE):   # (P N, in) -> (P N, out)
        return dense(lin, x, PN, new(PN, lin.out_features), act=act)

    def norm(ln, x, res, out, rows=PN, xrows=None):
        prog.layernorm((x, 0), (out, 0), rows, C, C, C, ln.weight.float(), ln.bias.float(),
                       res=None if res is None else (res, 0), xrows=xrows)
        return out

    def add_pe(x, out, n):
        prog.add((x, 0), (pe, 0), (out, 0), n, ny=L * C)
        return out

    def qpe(Q):
        out = new(PN, C)
        prog.add((Q, 0), (tokens, 0), (out, 0), PN * C)
        return out

    def bd(x, T, scaled):   # (P, T, I) -> (P, nh T, I)
        I = x.shape[-1]
        out = new(P, nh * T, I)
        prog.bd((x, 0), (out, 0), P, T, I, nh, _scale_in(dt, I // nh) if scaled else 0.0)
        return out

    def fold(x, T, lin, *, transposed=False, bias=True):
        """x (P, T, Ci) @ lin's weight (Ci, C) (or its transpose) -> (P, T,
        C) rounded, and x . lin's bias (P, T) float32."""
        out = new(P, T, C)
        prog.gemm((x, 0), (lin.weight, 0), (out, 0), P, T, C, Ci, (T * Ci, Ci, 1),
                  (0, 1, Ci) if transposed else (0, C, 1), (T * C, C, 1), useful=1 / nh)
        if not bias:
            return out
        xb = new(P, T, dtype=f32)
        prog.gemm((x, 0), (lin.bias.float(), 0), (xb, 0), P, T, 1, Ci, (T * Ci, Ci, 1),
                  (0, 1, 0), (T, 1, 1), useful=1 / nh)
        return out, xb

    def image_attention(a, Q, keys, kz, region):
        """Tokens attending to the L image keys (kz: their z stride) through
        a's projections: the pre-LN residual term (P N, C)."""
        tq = tok(a.q, qpe(Q))
        if "t2i" in fused:
            qk, rsb = fold(bd(tq.view(P, N, Ci), N, True), M, a.k)
            pk, rs = new(P, M, C), new(P, M, dtype=f32)
            prog.region = region
            prog.tw_t2i((qk, 0), (rsb, 0), (keys, 0), kz, pe, (pk, 0), (rs, 0), P, M, L, C)
            prog.region = "token"
            o = new(P, M, Ci, dtype=f32)   # pk W_v^T + rs (x) b_v
            prog.gemm((pk, 0), (a.v.weight, 0), (o, 0), P, M, Ci, C, (M * C, C, 1), (0, 1, C),
                      (M * Ci, Ci, 1), rowadd=(rs, M), bias=a.v.bias.float(), outer=True)
            ext = new(PN, Ci)
            prog.head_extract((o, 0), (ext, 0), P, N, Ci, nh)
            return tok(a.out, ext)
        prog.region = region
        rows = L if kz == 0 else P * L
        kpe = add_pe(keys, scratch("a", rows, C), rows * C)
        kh = dense(a.k, kpe, rows, scratch("b", rows, Ci))
        vh = dense(a.v, keys, rows, scratch("c", rows, Ci))
        to = new(PN, Ci)
        prog.tw_attn_image((tq, 0), (kh, 0), (vh, 0), (to, 0), P, N, L, Ci, nh,
                           0 if kz == 0 else L * Ci, sc)
        prog.region = "token"
        return tok(a.out, to)

    K = new(P, L, C)         # the keys state (I's output)
    keys, kz = base, 0 if Bi == 1 else L * C
    Q = new(PN, C)           # the queries state
    for i, p in enumerate(twt.layers):
        prog.region = "token"
        sa = p.self_attn
        src = tokens if i == 0 else qpe(Q)
        x = tokens if i == 0 else Q
        # q and k (and v in layer 0, where its input is theirs) as one product
        qkv = new(3 if i == 0 else 2, PN, Csa)
        _stacked_dense(prog, [sa.q, sa.k, sa.v][:qkv.shape[0]], (src, 0), qkv, PN, xz=0, xs=C,
                       oz=PN * Csa, os_=Csa)
        tq, tk, tv = qkv[0], qkv[1], qkv[2] if i == 0 else tok(sa.v, x)
        to = new(PN, Csa)
        prog.tw_attn_tokens((tq, 0), (tk, 0), (tv, 0), (to, 0), P, N, N, Csa, nh, ssa)
        att = tok(sa.out, to)
        if i == 0:
            norm(p.norm1, att, None, Q)
        else:
            norm(p.norm1, Q, att, Q)
        norm(p.norm2, Q, image_attention(p.cross_attn_t2i, Q, keys, kz, "t2i"), Q)
        norm(p.norm3, Q, tok(p.mlp.fc2, tok(p.mlp.fc1, Q, ACT_RELU)), Q)

        ia = p.cross_attn_i2t
        if "i2t" in fused:
            # the token columns padded to Np a head: the rows past N stay zero
            tk, tv = (torch.zeros(P, Np, Ci, dtype=dt, device=dev) for _ in range(2))
            for lin, x, out in ((ia.k, qpe(Q), tk), (ia.v, Q, tv)):
                prog.gemm((x, 0), (lin.weight, 0), (out, 0), P, N, Ci, C, (N * C, C, 1),
                          (0, 1, C), (Np * Ci, Ci, 1), bias=lin.bias.float())
            kq, kbq = fold(bd(tk, Np, True), nh * Np, ia.q)
            vw = fold(bd(tv, Np, False), nh * Np, ia.out, transposed=True, bias=False)
            prog.region = "i2t_norm4"
            prog.tw_i2t_norm4((keys, 0), kz, pe, (kq, 0), (kbq, 0), (vw, 0), ia.out.bias.float(),
                              p.norm4, (K, 0), P, nh * Np, L, C, nh, N)
        else:
            tk, tv = tok(ia.k, qpe(Q)), tok(ia.v, Q)
            prog.region = "i2t_norm4"
            rows = L if kz == 0 else P * L
            kpe = add_pe(keys, scratch("a", rows, C), rows * C)
            qi = dense(ia.q, kpe, rows, scratch("b", rows, Ci))
            oimg = scratch("c", P * L, Ci)
            prog.tw_attn_rows((qi, 0), 0 if kz == 0 else L * Ci, (tk, 0), (tv, 0), (oimg, 0), P,
                              L, N, Ci, nh, sc)
            tmp = dense(ia.out, oimg, P * L, scratch("a", P * L, C))   # kpe is read
            norm(p.norm4, keys, tmp, K, rows=P * L, xrows=rows)
        keys, kz = K, L * C
        prog.region = "token"

    queries = Q if decoder is not None else new(P, N, C)
    norm(twt.norm_final, Q, image_attention(twt.final_attn, Q, K, L * C, "final"), queries)
    if decoder is None:
        return prog, (queries, K)
    return prog, _tw_head(prog, decoder, fused, Q, K, P, N, Hs, Ws, scratch)


def _stacked_dense(prog, lins, x, out, M: int, *, xz, xs, oz, os_, act=ACT_NONE) -> None:
    """out[z] (M rows) = act(round(x[z] w_z^T + b_z)), z over ``lins``, as
    one product: their weights stacked and their biases the product's
    float32 addend (copies made when recorded).  x = (tensor, offset) with
    z and row strides xz, xs; out's z and row strides oz, os_."""
    Z, K, Nn = len(lins), lins[0].in_features, lins[0].out_features
    w = torch.stack([lin.weight for lin in lins])
    b = torch.empty(out.shape, dtype=torch.float32, device=out.device)
    _view(b, 0, (Z, M, Nn), (oz, os_, 1)).copy_(
        torch.stack([lin.bias.float() for lin in lins])[:, None])
    prog.gemm(x, (w, 0), (out, 0), Z, M, Nn, K, (xz, xs, 1), (Nn * K, 1, K), (oz, os_, 1),
              beta=(b, 0), act=act)


def _tw_head(prog, decoder, fused, Q, K, P: int, N: int, Hs: int, Ws: int, scratch):
    """Kernel H's tail on the recorded sequence of :func:`tw_program`: the
    IoU head and the hypernetwork MLPs on rows 0 and 1 + t of every
    prompt's queries Q (P N, C), then the upscale of the keys K (P, L, C)
    and the masks (the unfused upscale's intermediates in tw_program's
    ``scratch`` slots).  Returns (masks, or the mask columns of the fused
    upscale, and iou)."""
    dt, dev = Q.dtype, Q.device
    L, C = Hs * Ws, Q.shape[-1]

    def new(*shape):
        return torch.empty(shape, dtype=dt, device=dev)

    prog.region = "head"
    head = decode_head_params(decoder)
    nt = len(head["hyper"])

    def mlps(stacks, row, out, oz, os_):
        """MLPs of one shape, stack s on row ``row`` + s of every prompt's
        queries: each layer one product batched over the stacks (weights
        stacked once), the last into out (z and row strides oz, os_)."""
        x, xz, xs = (Q, row * C), C, N * C
        n = len(stacks[0].layers)
        for j in range(n):
            last = j == n - 1
            lins = [st.layers[j] for st in stacks]
            y = out if last else new(len(stacks), P, lins[0].out_features)
            yz, ys = (oz, os_) if last else (P * y.shape[-1], y.shape[-1])
            _stacked_dense(prog, lins, x, y, P, xz=xz, xs=xs, oz=yz, os_=ys,
                           act=ACT_NONE if last else ACT_RELU)
            x, xz, xs = (y, 0), yz, ys

    iou = new(P, nt)
    w1, b1 = (t.contiguous() for t in head["conv1"])
    w2, b2 = (t.contiguous() for t in head["conv2"])
    co1, co2 = w2.shape[0], w2.shape[1] // 4
    hyper = new(P, nt, co2)
    mlps([head["iou"]], 0, iou, 0, nt)
    mlps(head["hyper"], 1, hyper, co2, nt * co2)
    ln = head["ln"]
    if "upscale" in fused:
        hbd = new(P, 4 * nt, 4 * co2)
        prog.hbd((hyper, 0), (hbd, 0), P, nt, co2)
        prog.region = "upscale"
        cols = new(P, L, 16 * nt)
        prog.tw_upscale((K, 0), w1, b1.float(), ln, w2, b2.float(), (hbd, 0), (cols, 0), P, L, nt)
        return cols, iou
    prog.region = "upscale"
    y1 = scratch("a", P * L * 4, co1)
    prog.gemm((K, 0), (w1, 0), (y1, 0), 1, P * L, 4 * co1, C, (0, C, 1), (0, 4 * co1, 1),
              (0, 4 * co1, 1), bias=b1.float())
    z = scratch("b", P * L * 4, co1)
    prog.layernorm((y1, 0), (z, 0), P * L * 4, co1, co1, co1, ln.weight.float(),
                   ln.bias.float(), gelu=True)
    z2 = scratch("c", P * L * 4, 4 * co2)
    prog.gemm((z, 0), (w2, 0), (z2, 0), 1, P * L * 4, 4 * co2, co1, (0, co1, 1),
              (0, 4 * co2, 1), (0, 4 * co2, 1), bias=b2.float(), act=ACT_GELU)
    prog.region = "masks"
    masks = new(P, nt, 4 * Hs, 4 * Ws)
    prog.tw_masks((z2, 0), (hyper, 0), (masks, 0), P, Hs, Ws, nt, co2)
    return masks, iou


class _TwPlan:
    """Kernel H's or I's launch sequence for one set of weights and shapes,
    recorded once with input buffers of its own and replayed on every call:
    the float32 copies of the biases and norm weights, the upscale's matmul
    weights, the scratch and the packed records are made once.  A call
    copies its base, positional encoding and tokens in, runs the records
    in one C call and copies the outputs out (the buffers are the next
    call's).  Besides its inputs, a plan holds the keys state (P, L, C),
    the outputs and the token side's small buffers; the float32 route also
    holds one layer's intermediates over L (``tw_program``'s scratch slots,
    shared by the layers and the upscale: 1.3 GB at 64 prompts of
    sam_vit_h's decoder).  Plans live while their transformer module does
    (``_PLANS``)."""

    def __init__(self, kernel, twt, decoder, image_embedding, tokens, num_heads):
        Bi, Hs, Ws, C = image_embedding.shape
        dt, dev = image_embedding.dtype, image_embedding.device
        self.kernel, self.hw = kernel, (Hs, Ws)
        self.base = torch.empty(image_embedding.shape, dtype=dt, device=dev)
        self.pe = torch.empty(Hs * Ws, C, dtype=dt, device=dev)
        self.tokens = torch.empty(tokens.shape, dtype=dt, device=dev)
        self.prog, self.outs = tw_program(twt, decoder, self.base, self.pe, self.tokens,
                                          num_heads)
        self.packed = self.prog.pack()

    def launch(self) -> None:
        launch_records(self.packed, kernel=self.kernel)

    def run(self, image_embedding, image_pe, tokens):
        self.base.copy_(image_embedding)
        self.pe.copy_(image_pe.reshape(-1, *self.pe.shape)[0])
        self.tokens.copy_(tokens)
        self.launch()
        a, b = self.outs
        if self.kernel is TWOWAY_DECODE and a.dim() == 3:   # mask columns
            return unpermute_masks(a, a.shape[0], *self.hw, b.shape[-1]), b.clone()
        return a.clone(), b.clone()


def _check_fused(twt, decoder, image_embedding, image_pe, tokens, num_heads: int) -> None:
    """Raise on what kernels H and I do not take."""
    dt = image_embedding.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"expected bf16 or float32, got {dt}")
    if not all(t.is_cuda for t in (image_embedding, image_pe, tokens)):
        raise ValueError("expected CUDA tensors")
    if image_pe.dim() == 4 and image_pe.shape[0] > 1:
        raise ValueError("a per-batch positional encoding is not supported")
    Bi, Hs, Ws, C = image_embedding.shape
    P, N = tokens.shape[0], tokens.shape[1]
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
    if dt == torch.bfloat16 and (C != 256 or num_heads != 8 or (Hs * Ws) % FUSED_TILE or (
            decoder is not None and (len(decoder.hyper_mlps) != 4 or co2 != 32
                                     or decoder.upscale_conv2.weight.shape[1] != 64))):
        raise ValueError("the bf16 route takes SAM's decoder widths (C 256, 8 heads, 4 mask "
                         "tokens, upscale 256 -> 64 -> 32) and L a multiple of 64")


# a plan a module of weights, kept while the module lives
_PLANS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _plan(kernel: Kernel, twt, decoder, image_embedding, tokens, num_heads: int) -> _TwPlan:
    """The plan kept for kernel H or I (``kernel``) with these weights and
    shapes (:func:`cached`): recorded anew when a weight changed, or P, N,
    the base's batch, the dtype or the kernel did."""
    weights = list(twt.parameters()) + ([] if decoder is None else list(decoder.parameters()))
    return cached(_PLANS.setdefault(twt, {}), kernel.name, weights,
                  lambda *_: _TwPlan(kernel, twt, decoder, image_embedding, tokens, num_heads),
                  extra=(id(decoder), tuple(image_embedding.shape), tuple(tokens.shape),
                         image_embedding.dtype, num_heads))


def _twoway_fused(kernel: Kernel, twt, decoder, image_embedding, image_pe, tokens,
                  num_heads: int):
    """Kernel I (``decoder`` None) or H on CUDA tensors: one launch of its
    plan (:func:`_plan`)."""
    _check_fused(twt, decoder, image_embedding, image_pe, tokens, num_heads)
    return _plan(kernel, twt, decoder, image_embedding, tokens, num_heads).run(
        image_embedding, image_pe, tokens)


def fused_twoway_apply(twt, image_embedding, image_pe, point_embedding, num_heads: int):
    """Kernel I wrapper: shapes and result as :func:`fused_twoway_plain`.  A
    CPU tensor takes the plain version; a CUDA tensor (bf16 or float32)
    launches the kernel or raises."""
    if image_embedding.device.type == "cpu":
        return fused_twoway_plain(twt, image_embedding, image_pe, point_embedding, num_heads)
    if image_embedding.shape[0] != point_embedding.shape[0]:
        raise ValueError("the transformer needs an image embedding per prompt")
    return _twoway_fused(TWOWAY_TRANSFORMER, twt, None, image_embedding, image_pe,
                         point_embedding, num_heads)


def twoway_decode(twt, decoder, image_embedding, image_pe, tokens, num_heads: int):
    """Kernel H wrapper: shapes and result as :func:`fused_decode_plain`.  A
    CPU tensor takes the plain version; a CUDA tensor (bf16 or float32)
    launches the kernel or raises."""
    if image_embedding.device.type == "cpu":
        return fused_decode_plain(twt, decoder, image_embedding, image_pe, tokens, num_heads)
    return _twoway_fused(TWOWAY_DECODE, twt, decoder, image_embedding, image_pe, tokens,
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
