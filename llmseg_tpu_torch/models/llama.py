"""LLaMA decoder, bf16 path, the counterpart of ``llmseg_tpu.models.llama``.

Takes token ids or pre-spliced input embeddings and returns the final-norm
hidden states; :func:`logits` maps them to float32 logits.  Causal attention
goes through ``ops.attention.attention``, which sends the 767-token
ReasonSeg sequences to kernel A on the card (and, under autograd, kernels C
and D backward).  Layers may be checkpointed (``remat``).  LoRA on q/v is an
optional overlay module (:class:`LlamaLora`); the quantized branches of the
JAX package are not part of the port yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

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

    def qkv(self, x_raw, cos, sin, lora: Optional[nn.ModuleDict], scaling: float,
            positions: Optional[torch.Tensor] = None):
        """RMSNorm, the q/k/v projections (LoRA on q/v) and RoPE at
        ``positions`` (B, T) (0..T-1 when None): q (B, T, H, Dh), k and v
        (B, T, H_kv, Dh)."""
        cfg = self.cfg
        B, T, _ = x_raw.shape
        x = self.input_norm(x_raw)
        lq = lora["q"] if lora is not None and "q" in lora else None
        lv = lora["v"] if lora is not None and "v" in lora else None
        q = _dense_lora(self.attn.q, lq, x, scaling)
        k = self.attn.k(x)
        v = _dense_lora(self.attn.v, lv, x, scaling)
        q = L.apply_rope(q.reshape(B, T, cfg.num_heads, cfg.head_dim), cos, sin, positions)
        k = L.apply_rope(k.reshape(B, T, cfg.num_kv_heads, cfg.head_dim), cos, sin, positions)
        return q, k, v.reshape(B, T, cfg.num_kv_heads, cfg.head_dim)

    def repeat_kv(self, k, v):
        """Grouped-query heads: k and v repeated to the query heads."""
        rep = self.cfg.num_heads // self.cfg.num_kv_heads
        if rep == 1:
            return k, v
        return k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)

    def attn_block(self, x_raw, cos, sin, lora: Optional[nn.ModuleDict],
                   scaling: float):
        B, T, _ = x_raw.shape
        q, k, v = self.qkv(x_raw, cos, sin, lora, scaling)
        k, v = self.repeat_kv(k, v)
        o = attention(q, k, v, causal=True).reshape(B, T, -1)
        return self.attn.o(o)

    def forward(self, x, cos, sin, lora=None, scaling: float = 1.0):
        x = x + self.attn_block(x, cos, sin, lora, scaling)
        return x + self.mlp(self.post_norm(x))


_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """``dots_with_no_batch_dims_saveable``: keep the outputs of the
    projection products (2-D mm / addmm: nn.Linear on (B, T, C), LoRA
    included); recompute everything else, attention's batched products and
    kernels included."""
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return create_selective_checkpoint_contexts(_save_dots)


def remat_policy(remat) -> str:
    """``llama.apply``'s remat argument as one of "none", "full", "dots"."""
    policy = {False: "none", None: "none", True: "full"}.get(remat, remat)
    if policy not in ("none", "full", "dots"):
        raise ValueError(f"remat must be False/'none', True/'full' or 'dots', got {remat!r}")
    return policy


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
                lora_cfg: Optional[LoraConfig] = None, remat=False) -> torch.Tensor:
        """Final-norm hidden states (B, T, C).  ``remat`` checkpoints each
        layer: False/"none" keeps every activation, True/"full" recomputes
        the whole layer in the backward, "dots" keeps the projection
        products and recomputes the rest (``llama.apply``'s policies)."""
        cfg = self.cfg
        policy = remat_policy(remat)
        x = self.embed_tokens(input_ids) if inputs_embeds is None else inputs_embeds
        T = x.shape[1]
        if T > cfg.max_seq_len:
            raise ValueError(f"sequence length {T} > max_seq_len {cfg.max_seq_len}")
        cos, sin = L.rope_frequencies(cfg.head_dim, cfg.max_seq_len,
                                      cfg.rope_theta, device=x.device)
        scaling = 1.0 if lora_cfg is None else lora_cfg.alpha / lora_cfg.rank
        for i, layer in enumerate(self.layers):
            args = (x, cos[:T], sin[:T], None if lora is None else lora.layers[i], scaling)
            if policy == "none" or not torch.is_grad_enabled():
                x = layer(*args)
            elif policy == "full":
                x = checkpoint(layer, *args, use_reentrant=False)
            else:
                x = checkpoint(layer, *args, use_reentrant=False, context_fn=_dots_context)
        return self.norm(x)


class _LogitsMM(torch.autograd.Function):
    """(N, C) x (V, C)^T in bf16 with float32 accumulation and a float32
    result (``torch.mm``'s ``out_dtype``).  PyTorch has no derivative for
    that overload, so the backward is written here: the float32 cotangent
    is rounded to the weight's dtype for its two products, which is what
    the gradients are stored in."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        return torch.mm(h, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        g = g.to(w.dtype)
        dh = g @ w if ctx.needs_input_grad[0] else None
        dw = g.t() @ h if ctx.needs_input_grad[1] else None
        return dh, dw


_HAS_MM_OUT_DTYPE = hasattr(torch.ops.aten.mm, "dtype")


def logits(model: Llama, hidden: torch.Tensor) -> torch.Tensor:
    """(B, T, C) -> (B, T, V) float32 logits, the product accumulated in
    float32 (``llama.logits``).  Low-precision CUDA tensors use
    ``torch.mm(..., out_dtype=torch.float32)`` where the installed PyTorch
    has it; otherwise both operands are cast to float32 first."""
    w = model.embed_tokens.weight if model.cfg.tie_embeddings else model.lm_head.weight
    lead = hidden.shape[:-1]
    h = hidden.reshape(-1, hidden.shape[-1])
    if h.is_cuda and h.dtype != torch.float32 and _HAS_MM_OUT_DTYPE:
        out = _LogitsMM.apply(h, w)
    else:
        out = h.float() @ w.float().t()
    return out.reshape(*lead, w.shape[0])
