"""Greedy generation with a KV cache, the counterpart of
``llmseg_tpu.models.generate``.

It backs the legacy pixel-decoder path (``models.pixel_decoder``).  The
prefill runs the prompt through the LLaMA layers once and records K and V
in a static cache of T + max_new_tokens positions; its causal attention
goes through ``ops.attention.attention`` (kernel A on the card).  Each
decode step writes its K and V into the cache in place and attends over
the whole cache with the plain attention and a -1e9 mask on the positions
after it, as the JAX package's step does with ``attention_xla``.  It runs
on a whole LLaMA: one sharded over a mesh with fsdp or tp above 1
(``parallel/mesh.py``) raises.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from llmseg_tpu_torch.config import LoraConfig, require_ported
from llmseg_tpu_torch.models import layers as L
from llmseg_tpu_torch.models import llama
from llmseg_tpu_torch.models.llama import Llama, LlamaLora
from llmseg_tpu_torch.ops.attention import NEG_INF, attention, attention_plain


def _scaling(lora_cfg: Optional[LoraConfig]) -> float:
    return 1.0 if lora_cfg is None else lora_cfg.alpha / lora_cfg.rank


def prefill_cache(llm: Llama, inputs_embeds: torch.Tensor, total_len: int, *,
                  lora: Optional[LlamaLora] = None, lora_cfg: Optional[LoraConfig] = None
                  ) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor, torch.Tensor]]]:
    """The prompt (B, T, C) through the model, recording K and V.  Returns
    (final-norm hidden states (B, T, C), per layer (k, v) caches of shape
    (B, total_len, H_kv, Dh), positions T and later zero)."""
    require_ported(llm.cfg, "cache")
    if llm.mesh is not None:
        raise NotImplementedError("generation runs on a whole LLaMA, not one sharded "
                                  "over a mesh with fsdp or tp above 1")
    cfg = llm.cfg
    B, T, _ = inputs_embeds.shape
    cos, sin = L.rope_frequencies(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta,
                                  device=inputs_embeds.device)
    scaling = _scaling(lora_cfg)
    x = inputs_embeds
    cache = []
    for i, layer in enumerate(llm.layers):
        q, k, v = layer.qkv(x, cos[:T], sin[:T], None if lora is None else lora.layers[i],
                            scaling)
        ck = k.new_zeros((B, total_len) + k.shape[2:])
        cv = v.new_zeros((B, total_len) + v.shape[2:])
        ck[:, :T], cv[:, :T] = k, v
        cache.append((ck, cv))
        o = attention(q, *layer.repeat_kv(k, v), causal=True)
        x = x + layer.attn.o(o.reshape(B, T, -1))
        x = x + layer.mlp_block(x)
    return llm.norm(x), cache


def _layer_cached(layer, lora, x, ck, cv, pos: int, cos, sin, scaling: float):
    """One decode step of one layer: x (B, 1, C); the step's K and V go to
    cache position ``pos`` in place."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
    q, k, v = layer.qkv(x, cos, sin, lora, scaling, positions)
    ck[:, pos], cv[:, pos] = k[:, 0], v[:, 0]
    S = ck.shape[1]
    bias = torch.where(torch.arange(S, device=x.device) <= pos, 0.0, NEG_INF)
    o = attention_plain(q, *layer.repeat_kv(ck, cv), bias=bias[None, None, None, :])
    x = x + layer.attn.o(o.reshape(B, 1, -1))
    return x + layer.mlp_block(x)


@torch.inference_mode()
def greedy_generate(llm: Llama, inputs_embeds: torch.Tensor, max_new_tokens: int, *,
                    eos_token_id: int = 2, lora: Optional[LlamaLora] = None,
                    lora_cfg: Optional[LoraConfig] = None,
                    stop_token_ids: Sequence[int] = ()) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy decode of max_new_tokens after the prompt (B, T, C).  Returns
    (tokens (B, N), hidden states (B, N, C)): the final-norm hidden state at
    each generated position.  A row is done once it has emitted EOS or a
    ``stop_token_ids`` token (checked before the next token is chosen);
    then it repeats EOS, and every row runs all N steps."""
    require_ported(llm.cfg, "cache")
    cfg = llm.cfg
    B, T, _ = inputs_embeds.shape
    total = T + max_new_tokens
    if total > cfg.max_seq_len:
        raise ValueError(f"{T} prompt + {max_new_tokens} new tokens > max_seq_len "
                         f"{cfg.max_seq_len}")
    hidden, cache = prefill_cache(llm, inputs_embeds, total, lora=lora, lora_cfg=lora_cfg)
    cos, sin = L.rope_frequencies(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta,
                                  device=inputs_embeds.device)
    scaling = _scaling(lora_cfg)
    tok = llama.logits(llm, hidden[:, -1:])[:, 0].argmax(-1)
    done = torch.zeros(B, dtype=torch.bool, device=tok.device)
    tokens, hiddens = [], []
    for i in range(max_new_tokens):
        x = llm.embed_tokens(tok)[:, None, :]
        for li, layer in enumerate(llm.layers):
            x = _layer_cached(layer, None if lora is None else lora.layers[li], x,
                              *cache[li], T + i, cos, sin, scaling)
        h = llm.norm(x)
        for sid in (eos_token_id, *stop_token_ids):
            done = done | (tok == sid)
        tokens.append(tok)
        hiddens.append(h[:, 0])
        if i + 1 < max_new_tokens:
            nxt = llama.logits(llm, h)[:, 0].argmax(-1)
            tok = torch.where(done, eos_token_id, nxt)
    return torch.stack(tokens, 1), torch.stack(hiddens, 1)
