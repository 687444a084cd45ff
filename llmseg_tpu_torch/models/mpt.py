"""MPT decoder, the counterpart of ``llmseg_tpu.models.mpt`` (the
reference's vendored model/llava/model/language_model/mpt/, an alternative
LLaVA backbone that no LLM-Seg entry point selects):

  * ALiBi: a per-key bias, slopes 2^(-alibi_bias_max i / n') with the
    odd/even interleave for head counts that are not a power of two
    (:func:`gen_slopes`, :func:`build_alibi_bias`); positions enter only
    through it, or through a learned ``wpe`` table when ALiBi is off;
  * one fused Wqkv projection, optionally clamped (``clip_qkv``), with an
    optional LayerNorm of q and k over the flat projection dim (``qk_ln``);
  * MultiQueryAttention when ``kv_n_heads`` < ``n_heads``: k and v repeated
    over the query heads;
  * pre-LN blocks (float32 statistics) with an exact-GELU FFN;
  * logits tied to ``wte``.

Attention takes its bias with ``causal=True``, which ``ops.attention``
sends to the plain path (the JAX package sends it to ``attention_xla``):
MPT runs no kernel.  Parameter names follow the JAX tree, so
``from_jax.load_`` loads it as it is.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from llmseg_tpu_torch.config import MptConfig
from llmseg_tpu_torch.models import layers as L
from llmseg_tpu_torch.ops.attention import attention

PAD_BIAS = -1e9


def gen_slopes(n_heads: int, alibi_bias_max: int = 8) -> np.ndarray:
    """The reference's gen_slopes: a ladder over the next power of two,
    interleaved odd/even when ``n_heads`` is not one.  (n_heads,) float32."""
    n2 = 2 ** math.ceil(math.log2(n_heads))
    m = np.arange(1, n2 + 1, dtype=np.float32) * (alibi_bias_max / n2)
    slopes = 1.0 / np.power(2.0, m)
    if n2 != n_heads:
        slopes = np.concatenate([slopes[1::2], slopes[0::2]])[:n_heads]
    return slopes


def build_alibi_bias(n_heads: int, seq_len: int, alibi_bias_max: int = 8, *,
                     device=None) -> torch.Tensor:
    """(1, n_heads, 1, seq_len) float32 bias slope * (k - (S - 1)); under the
    causal mask it equals the |q - k| form up to a per-row constant, which
    the softmax cancels."""
    dist = np.arange(1 - seq_len, 1, dtype=np.float32).reshape(1, 1, 1, -1)
    slopes = gen_slopes(n_heads, alibi_bias_max).reshape(1, -1, 1, 1)
    return torch.from_numpy(dist * slopes).to(device)


class MptAttention(nn.Module):
    def __init__(self, cfg: MptConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=not cfg.no_bias, device=device, dtype=dtype)
        d = cfg.d_model
        kv_dim = cfg.kv_n_heads * (d // cfg.n_heads)
        self.cfg = cfg
        self.wqkv = nn.Linear(d, d + 2 * kv_dim, **kw)
        self.out_proj = nn.Linear(d, d, **kw)
        if cfg.qk_ln:
            self.q_ln = L.LayerNorm(d, cfg.ln_eps, device=device, dtype=dtype)
            self.k_ln = L.LayerNorm(kv_dim, cfg.ln_eps, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, T, d = x.shape
        hd = d // cfg.n_heads
        kv_dim = cfg.kv_n_heads * hd
        qkv = self.wqkv(x)
        if cfg.clip_qkv:
            qkv = qkv.clamp(-cfg.clip_qkv, cfg.clip_qkv)
        q, k, v = qkv[..., :d], qkv[..., d:d + kv_dim], qkv[..., d + kv_dim:]
        if cfg.qk_ln:
            q, k = self.q_ln(q).to(v.dtype), self.k_ln(k).to(v.dtype)
        q = q.reshape(B, T, cfg.n_heads, hd)
        k = k.reshape(B, T, cfg.kv_n_heads, hd)
        v = v.reshape(B, T, cfg.kv_n_heads, hd)
        if cfg.kv_n_heads != cfg.n_heads:
            rep = cfg.n_heads // cfg.kv_n_heads
            k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
        scale = cfg.softmax_scale or (1.0 / math.sqrt(hd))
        o = attention(q, k, v, bias=bias, causal=True, scale=scale)
        return self.out_proj(o.reshape(B, T, d))


class MptFFN(nn.Module):
    def __init__(self, cfg: MptConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=not cfg.no_bias, device=device, dtype=dtype)
        self.up_proj = nn.Linear(cfg.d_model, cfg.expansion_ratio * cfg.d_model, **kw)
        self.down_proj = nn.Linear(cfg.expansion_ratio * cfg.d_model, cfg.d_model, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.gelu(self.up_proj(x)))


class MptBlock(nn.Module):
    def __init__(self, cfg: MptConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm_1 = L.LayerNorm(cfg.d_model, cfg.ln_eps, **kw)
        self.attn = MptAttention(cfg, **kw)
        self.norm_2 = L.LayerNorm(cfg.d_model, cfg.ln_eps, **kw)
        self.ffn = MptFFN(cfg, **kw)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm_1(x), bias)
        return x + self.ffn(self.norm_2(x))


class Mpt(nn.Module):
    def __init__(self, cfg: MptConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.wte = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model, **kw))
        self.blocks = nn.ModuleList(MptBlock(cfg, **kw) for _ in range(cfg.n_layers))
        self.norm_f = L.LayerNorm(cfg.d_model, cfg.ln_eps, **kw)
        self.wpe = (nn.Parameter(torch.empty(cfg.max_seq_len, cfg.d_model, **kw))
                    if not cfg.alibi and cfg.learned_pos_emb else None)

    def forward(self, *, input_ids: Optional[torch.Tensor] = None,
                inputs_embeds: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Final hidden states (B, T, d).  ``attention_mask`` (B, T), true
        where valid: padding keys get -1e9 in every softmax."""
        cfg = self.cfg
        x = self.wte[input_ids] if inputs_embeds is None else inputs_embeds
        B, T, _ = x.shape
        if cfg.alibi:
            bias = build_alibi_bias(cfg.n_heads, T, cfg.alibi_bias_max, device=x.device)
            bias = bias.expand(1, cfg.n_heads, T, T)
        else:
            if self.wpe is not None:
                x = x + self.wpe[:T][None]
            bias = torch.zeros(1, cfg.n_heads, T, T, device=x.device)
        if attention_mask is not None:
            pad = torch.where(attention_mask.bool()[:, None, None, :], 0.0, PAD_BIAS)
            bias = bias + pad
        for block in self.blocks:
            x = block(x, bias)
        return self.norm_f(x)


def logits(model: Mpt, hidden: torch.Tensor) -> torch.Tensor:
    """The head tied to ``wte``: (B, T, d) -> (B, T, V)."""
    return torch.einsum("btd,vd->btv", hidden, model.wte)
