"""A plain float32 reference of DeepSeek-V3's decoder (Kimi-VL-A3B's
language model) for the port's tests: the equations of the published
modeling code written out with plain torch operations, on a dict of weights
named as the port's ``DeepseekV3`` state dict names them.  Imports nothing
of the port or of JAX.

Each piece is written independently of the port: RoPE rotates each
interleaved pair (x_2j, x_2j+1) by its own angle and writes the pair to
halves (j, j + D/2); the attention is one masked softmax; the experts run
one at a time on the tokens that chose them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope_pairs(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, T, H, D) at positions 0..T-1: pair j = (x_2j, x_2j+1) turned
    by t * theta^(-2j/D), written to (j, j + D/2); angles in float64."""
    T, D = x.shape[1], x.shape[3]
    ang = torch.arange(T, dtype=torch.float64)[:, None] * theta ** (
        -torch.arange(0, D, 2, dtype=torch.float64) / D)[None]
    cos, sin = ang.cos().float()[None, :, None], ang.sin().float()[None, :, None]
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], -1)


def swiglu(x, gate, up, down):
    return (torch.nn.functional.silu(x @ gate.t()) * (x @ up.t())) @ down.t()


def mla(W: Dict[str, torch.Tensor], p: str, cfg, h: torch.Tensor) -> torch.Tensor:
    B, T, _ = h.shape
    H, nope, rope, dv = (cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                         cfg.v_head_dim)
    q = (h @ W[p + "q.weight"].t()).reshape(B, T, H, nope + rope)
    kv_a = h @ W[p + "kv_a.weight"].t()
    c_kv, k_pe = kv_a[..., :cfg.kv_lora_rank], kv_a[..., cfg.kv_lora_rank:]
    kv = (rms_norm(c_kv, W[p + "kv_norm.weight"], cfg.kv_norm_eps)
          @ W[p + "kv_b.weight"].t()).reshape(B, T, H, nope + dv)
    q = torch.cat([q[..., :nope], rope_pairs(q[..., nope:], cfg.rope_theta)], -1)
    k_pe = rope_pairs(k_pe[:, :, None, :], cfg.rope_theta).expand(B, T, H, rope)
    k = torch.cat([kv[..., :nope], k_pe], -1)
    s = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(nope + rope)
    s = s.masked_fill(torch.ones(T, T, dtype=torch.bool).triu(1), float("-inf"))
    o = torch.einsum("bhts,bshd->bthd", torch.softmax(s, -1), kv[..., nope:])
    return o.reshape(B, T, H * dv) @ W[p + "o.weight"].t()


def route(W: Dict[str, torch.Tensor], p: str, cfg, x: torch.Tensor):
    """The experts (N, k) and weights (N, k) for tokens x (N, d)."""
    s = torch.sigmoid(x @ W[p + "router.weight"].t())
    idx = torch.topk(s + W[p + "router.correction_bias"], cfg.num_experts_per_tok, -1).indices
    w = s.gather(1, idx)
    return idx, w / (w.sum(-1, keepdim=True) + 1e-20) * cfg.routed_scaling_factor


def routed(W: Dict[str, torch.Tensor], p: str, cfg, x, idx, w) -> torch.Tensor:
    """sum over each token's experts of w_i E_i(x), one expert at a time."""
    E, I, d = cfg.n_routed_experts, cfg.moe_intermediate_size, x.shape[-1]
    gate_up = W[p + "experts.gate_up"].view(E, 2 * I, d)
    down = W[p + "experts.down"].view(E, d, I)
    out = torch.zeros_like(x)
    for e in range(E):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        y = swiglu(x[tok], gate_up[e, :I], gate_up[e, I:], down[e])
        out.index_add_(0, tok, y * w[tok, slot, None])
    return out


def moe(W, p, cfg, h, routes: Optional[List[torch.Tensor]] = None):
    x = h.reshape(-1, h.shape[-1])
    idx, w = route(W, p, cfg, x)
    if routes is not None:
        routes.append(idx)
    y = routed(W, p, cfg, x, idx, w) + swiglu(x, W[p + "shared.gate.weight"],
                                              W[p + "shared.up.weight"],
                                              W[p + "shared.down.weight"])
    return y.reshape(h.shape)


def decoder(W: Dict[str, torch.Tensor], cfg, x: torch.Tensor,
            routes: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """Input embeddings (B, T, d) -> final-norm hidden states, float32;
    ``routes`` collects each MoE layer's chosen experts."""
    W = {k: v.float() for k, v in W.items()}
    x = x.float()
    for i in range(cfg.num_layers):
        p = f"layers.{i}."
        x = x + mla(W, p + "attn.", cfg, rms_norm(x, W[p + "input_norm.weight"],
                                                  cfg.rms_norm_eps))
        h = rms_norm(x, W[p + "post_norm.weight"], cfg.rms_norm_eps)
        if i < cfg.first_k_dense_replace:
            x = x + swiglu(h, W[p + "mlp.gate.weight"], W[p + "mlp.up.weight"],
                           W[p + "mlp.down.weight"])
        else:
            x = x + moe(W, p + "mlp.", cfg, h, routes)
    return rms_norm(x, W["norm.weight"], cfg.rms_norm_eps)
