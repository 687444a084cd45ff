"""LLaMA decoder, bf16 path, the counterpart of ``llmseg_tpu.models.llama``.

Takes token ids or pre-spliced input embeddings and returns the final-norm
hidden states.  Causal attention goes through ``ops.attention.attention``,
which sends the 767-token ReasonSeg sequences to kernel A on the card.  LoRA
on q/v is an optional overlay module (:class:`LlamaLora`); the quantized
branches of the JAX package are not part of the port yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from llmseg_tpu_torch.config import LlamaConfig, LoraConfig
from llmseg_tpu_torch.models import layers as L
from llmseg_tpu_torch.ops.attention import attention


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        d, qd = cfg.hidden_size, cfg.num_heads * cfg.head_dim
        kvd = cfg.num_kv_heads * cfg.head_dim
        self.q = nn.Linear(d, qd, **kw)
        self.k = nn.Linear(d, kvd, **kw)
        self.v = nn.Linear(d, kvd, **kw)
        self.o = nn.Linear(qd, d, **kw)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        self.gate = nn.Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.up = nn.Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.down = nn.Linear(cfg.intermediate_size, cfg.hidden_size, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(F.silu(self.gate(x)) * self.up(x))


class LoraPair(nn.Module):
    """y += b(a(x)) * scaling; ``a`` is (rank, in), ``b`` (out, rank)."""

    def __init__(self, in_dim: int, rank: int, out_dim: int, *, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        self.a = nn.Linear(in_dim, rank, **kw)
        self.b = nn.Linear(rank, out_dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.b(self.a(x))


class LlamaLora(nn.Module):
    """LoRA A/B for the q/v projections of every layer (``lora_init``)."""

    def __init__(self, cfg: LlamaConfig, lora: LoraConfig, *, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        outs = {"q": cfg.num_heads * cfg.head_dim,
                "v": cfg.num_kv_heads * cfg.head_dim}
        self.layers = nn.ModuleList(
            nn.ModuleDict({name: LoraPair(cfg.hidden_size, lora.rank, out, **kw)
                           for name, out in outs.items()
                           if f"{name}_proj" in lora.target_modules})
            for _ in range(cfg.num_layers))


def _dense_lora(lin: nn.Linear, pair: Optional[LoraPair], x, scaling: float):
    y = lin(x)
    if pair is not None:
        y = y + pair(x) * scaling
    return y


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.input_norm = L.RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        self.attn = LlamaAttention(cfg, **kw)
        self.post_norm = L.RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        self.mlp = LlamaMLP(cfg, **kw)

    def attn_block(self, x_raw, cos, sin, lora: Optional[nn.ModuleDict],
                   scaling: float):
        cfg = self.cfg
        B, T, _ = x_raw.shape
        x = self.input_norm(x_raw)
        lq = lora["q"] if lora is not None and "q" in lora else None
        lv = lora["v"] if lora is not None and "v" in lora else None
        q = _dense_lora(self.attn.q, lq, x, scaling)
        k = self.attn.k(x)
        v = _dense_lora(self.attn.v, lv, x, scaling)
        q = L.apply_rope(q.reshape(B, T, cfg.num_heads, cfg.head_dim), cos, sin)
        k = L.apply_rope(k.reshape(B, T, cfg.num_kv_heads, cfg.head_dim), cos, sin)
        v = v.reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
        if cfg.num_kv_heads != cfg.num_heads:
            rep = cfg.num_heads // cfg.num_kv_heads
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        o = attention(q, k, v, causal=True).reshape(B, T, -1)
        return self.attn.o(o)

    def forward(self, x, cos, sin, lora=None, scaling: float = 1.0):
        x = x + self.attn_block(x, cos, sin, lora, scaling)
        return x + self.mlp(self.post_norm(x))


class Llama(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.layers = nn.ModuleList(LlamaLayer(cfg, **kw)
                                    for _ in range(cfg.num_layers))
        self.norm = L.RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        self.lm_head = (None if cfg.tie_embeddings else
                        nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False, **kw))

    def forward(self, *, input_ids: Optional[torch.Tensor] = None,
                inputs_embeds: Optional[torch.Tensor] = None,
                lora: Optional[LlamaLora] = None,
                lora_cfg: Optional[LoraConfig] = None) -> torch.Tensor:
        """Final-norm hidden states (B, T, C)."""
        cfg = self.cfg
        x = self.embed_tokens(input_ids) if inputs_embeds is None else inputs_embeds
        T = x.shape[1]
        if T > cfg.max_seq_len:
            raise ValueError(f"sequence length {T} > max_seq_len {cfg.max_seq_len}")
        cos, sin = L.rope_frequencies(cfg.head_dim, cfg.max_seq_len,
                                      cfg.rope_theta, device=x.device)
        scaling = 1.0 if lora_cfg is None else lora_cfg.alpha / lora_cfg.rank
        for i, layer in enumerate(self.layers):
            x = layer(x, cos[:T], sin[:T],
                      None if lora is None else lora.layers[i], scaling)
        return self.norm(x)
