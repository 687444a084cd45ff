"""LLaMA decoder, bf16 path, the counterpart of ``llmseg_tpu.models.llama``.

Takes token ids or pre-spliced input embeddings and returns the final-norm
hidden states; :func:`logits` maps them to float32 logits.  Causal attention
goes through ``ops.attention.attention``, which sends the 767-token
ReasonSeg sequences to kernel A on the card (and, under autograd, kernels C
and D backward).  Layers may be checkpointed (``remat``).  LoRA on q/v is an
optional overlay module (:class:`LlamaLora`).  A model quantized by
``ops.quant`` has quantized modules in place of its projections; where all
of a site's projections are W8A8, the RMSNorm before q/k/v and gate/up is
folded into the activation quantization (:func:`_rms_qdense`, kernel Q1 on
the card), and the products of one input share one quantization
(:func:`_shared_qdense`).  ``quant_stats`` collects SmoothQuant's
calibration statistics.

On a mesh with fsdp or tp above 1 (``parallel/mesh.py``'s
``shard_params`` sets ``mesh`` on the ``Llama`` and its layers) each
weight is this rank's block: a layer gathers its weights over fsdp where it
uses them, q, k, v, gate, up and LoRA B are split by columns over tp (the
local heads: H / tp, H_kv / tp), o and down by rows with their partial
products summed over tp, and the embedding and the logits are split by
vocabulary.  A quantized projection on a mesh holds its codes and scales
as blocks (``parallel/mesh.py``'s ``quant_spec``): a layer gathers them
over fsdp where it uses them (``mesh.fsdp_module``), runs the column split
on this rank's output columns as one process does, and the row split
through ``quant.qdense_rows`` (the products summed over tp before the
scales: in float32 for int8, in int32 for W8A8; int4 on the input
gathered over tp).  Without a mesh the path is the single-device one.
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
from llmseg_tpu_torch.ops import quant
from llmseg_tpu_torch.ops.attention import attention
from llmseg_tpu_torch.parallel import mesh as M


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


class LoraPair(nn.Module):
    """y += b(a(x)) * scaling; ``a`` is (rank, in), ``b`` (out, rank)."""

    def __init__(self, in_dim: int, rank: int, out_dim: int, *, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        self.a = nn.Linear(in_dim, rank, **kw)
        self.b = nn.Linear(rank, out_dim, **kw)

    def forward(self, x: torch.Tensor, mesh: Optional[M.Mesh] = None) -> torch.Tensor:
        """On a mesh: A gathered over fsdp, its output's gradient summed
        over tp (each tp rank's B is a block of columns)."""
        if mesh is None:
            return self.b(self.a(x))
        u = F.linear(x, M.fsdp_weight(self.a.weight, 1, mesh))
        return F.linear(M.copy_to_tp(u, mesh), self.b.weight)


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


def _shared_qdense(mods, x):
    """One activation quantization shared by the W8A8 products of one input
    (the same as quantizing for each: it depends on x alone).  None unless
    every module is W8A8.  On a mesh the column split's modules: the input
    is whole on every tp rank, the products give this rank's columns."""
    if not all(isinstance(m, L.W8A8Linear) for m in mods):
        return None
    qa = quant.quantize_activation(x)
    return [quant.qdense_act(m, qa, x.dtype) for m in mods]


def _rms_qdense(mods, x_raw, norm: L.RMSNorm, lora, stats):
    """RMSNorm folded into the shared quantization of the W8A8 products
    (``quant.rms_quantize_activation``): the normed tensor is never formed.
    None when a module is not W8A8, a LoRA overlay needs the normed tensor,
    calibration wants its statistics, or the outlier decomposition is on;
    the caller then takes RMSNorm and the unfused path."""
    if (lora is not None or stats is not None or quant.W8A8_OUTLIER_K > 0
            or not all(isinstance(m, L.W8A8Linear) for m in mods)):
        return None
    qa = quant.rms_quantize_activation(x_raw, norm.weight, norm.eps)
    return [quant.qdense_act(m, qa, x_raw.dtype) for m in mods]


def _colmax(x: torch.Tensor) -> torch.Tensor:
    """max |x| per input channel over every token: SmoothQuant's
    calibration statistic."""
    return x.float().abs().amax(dim=tuple(range(x.dim() - 1)))


class LlamaLayer(nn.Module):
    mesh: Optional[M.Mesh] = None     # set by parallel.mesh.shard_params

    def __init__(self, cfg: LlamaConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.input_norm = L.RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        self.attn = LlamaAttention(cfg, **kw)
        self.post_norm = L.RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        self.mlp = LlamaMLP(cfg, **kw)

    def _local(self, mods, out: str = "tp"):
        """The column split's modules (``out`` "tp"; the row split's:
        "fsdp") as a layer uses them: a quantized one with its codes and
        scales whole over fsdp, another as it is."""
        if self.mesh is None:
            return mods
        return [M.fsdp_module(m, out, self.mesh) if quant.is_quantized(m) else m for m in mods]

    def _w8a8(self, mods):
        """The modules of one input as the W8A8 routes take them (gathered
        over fsdp once, on a mesh), or as they are when one is not W8A8
        (the routes then decline them)."""
        if all(isinstance(m, L.W8A8Linear) for m in mods):
            return self._local(mods)
        return mods

    def _columns(self, mods, x):
        """The products of a column split: ``mod(x)`` each; on a mesh x's
        gradient summed over tp and each weight gathered over fsdp."""
        if self.mesh is None:
            return [m(x) for m in mods]
        x = M.copy_to_tp(x, self.mesh)
        return [m(x) if quant.is_quantized(m) else
                F.linear(x, M.fsdp_weight(m.weight, 1, self.mesh)) for m in self._local(mods)]

    def _rows(self, mod, x):
        """The product of a row split: ``mod(x)``; on a mesh the weight
        gathered over fsdp and the partial products summed over tp (a
        quantized one: ``quant.qdense_rows``)."""
        if self.mesh is None:
            return mod(x)
        if quant.is_quantized(mod):
            (mod,) = self._local((mod,), "fsdp")
            return mod(x) if self.mesh.tp == 1 else quant.qdense_rows(mod, x, self.mesh)
        return M.reduce_from_tp(F.linear(x, M.fsdp_weight(mod.weight, 0, self.mesh)),
                                self.mesh)

    def qkv(self, x_raw, cos, sin, lora: Optional[nn.ModuleDict], scaling: float,
            positions: Optional[torch.Tensor] = None, stats: Optional[dict] = None):
        """RMSNorm, the q/k/v projections (LoRA on q/v) and RoPE at
        ``positions`` (B, T) (0..T-1 when None): q (B, T, H, Dh), k and v
        (B, T, H_kv, Dh).  ``stats`` receives 'attn_in'."""
        cfg, a = self.cfg, self.attn
        B, T, _ = x_raw.shape
        w8a8 = self._w8a8((a.q, a.k, a.v))
        fused = _rms_qdense(w8a8, x_raw, self.input_norm, lora, stats)
        if fused is not None:
            q, k, v = fused
        else:
            x = self.input_norm(x_raw)
            if stats is not None:
                stats["attn_in"] = _colmax(x)
            shared = _shared_qdense(w8a8, x)
            q, k, v = shared if shared is not None else self._columns((a.q, a.k, a.v), x)
            if lora is not None and "q" in lora:
                q = q + lora["q"](x, self.mesh) * scaling
            if lora is not None and "v" in lora:
                v = v + lora["v"](x, self.mesh) * scaling
        # the heads this rank holds: all of them, or H / tp on a mesh
        q = L.apply_rope(q.reshape(B, T, -1, cfg.head_dim), cos, sin, positions)
        k = L.apply_rope(k.reshape(B, T, -1, cfg.head_dim), cos, sin, positions)
        return q, k, v.reshape(B, T, -1, cfg.head_dim)

    def repeat_kv(self, k, v):
        """Grouped-query heads: k and v repeated to the query heads."""
        rep = self.cfg.num_heads // self.cfg.num_kv_heads
        if rep == 1:
            return k, v
        return k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)

    def attn_block(self, x_raw, cos, sin, lora: Optional[nn.ModuleDict],
                   scaling: float, stats: Optional[dict] = None):
        B, T, _ = x_raw.shape
        q, k, v = self.qkv(x_raw, cos, sin, lora, scaling, stats=stats)
        k, v = self.repeat_kv(k, v)
        o = attention(q, k, v, causal=True).reshape(B, T, -1)
        if stats is not None:
            stats["o_in"] = _colmax(o)
        return self._rows(self.attn.o, o)

    def mlp_block(self, x_raw, stats: Optional[dict] = None):
        """RMSNorm and the MLP, ``_mlp_block``: the fused W8A8 route for
        gate/up where it applies.  ``stats`` receives 'mlp_in' and
        'down_in'."""
        m = self.mlp
        w8a8 = self._w8a8((m.gate, m.up))
        fused = _rms_qdense(w8a8, x_raw, self.post_norm, None, stats)
        if fused is not None:
            gate, up = fused
        else:
            x = self.post_norm(x_raw)
            if stats is not None:
                stats["mlp_in"] = _colmax(x)
            shared = _shared_qdense(w8a8, x)
            gate, up = shared if shared is not None else self._columns((m.gate, m.up), x)
        h = F.silu(gate) * up
        if stats is not None:
            stats["down_in"] = _colmax(h)
        return self._rows(m.down, h)

    def forward(self, x, cos, sin, lora=None, scaling: float = 1.0,
                stats: Optional[dict] = None):
        x = x + self.attn_block(x, cos, sin, lora, scaling, stats)
        return x + self.mlp_block(x, stats)


_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default) + (
    (torch.ops.aten.mm.dtype,) if hasattr(torch.ops.aten.mm, "dtype") else ())


def _save_dots(ctx, op, *args, **kwargs):
    """``dots_with_no_batch_dims_saveable``: keep the outputs of the
    projection products (2-D mm / addmm: nn.Linear on (B, T, C), LoRA
    included; a quantized base's products too: the weight-only int8 one is
    ``mm`` with ``out_dtype`` on the card, int4's a plain ``mm`` on the
    dequantized weight); recompute everything else, attention's batched
    products and kernels included."""
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
    mesh: Optional[M.Mesh] = None     # set by parallel.mesh.shard_params

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

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Token embeddings.  On a mesh the table is split by vocabulary
        over tp: ids outside this rank's rows give zeros, and the sum over
        tp has each id's row from its owner (exactly: the others add
        zeros); the gradient lands on the owner's rows alone."""
        if self.mesh is None:
            return self.embed_tokens(input_ids)
        w = M.fsdp_weight(self.embed_tokens.weight, 1, self.mesh)
        local = input_ids - self.mesh.coord("tp") * w.shape[0]
        inside = (local >= 0) & (local < w.shape[0])
        x = F.embedding(torch.where(inside, local, 0), w)
        return M.reduce_from_tp(torch.where(inside[..., None], x, 0.0), self.mesh)

    def forward(self, *, input_ids: Optional[torch.Tensor] = None,
                inputs_embeds: Optional[torch.Tensor] = None,
                lora: Optional[LlamaLora] = None,
                lora_cfg: Optional[LoraConfig] = None, remat=False,
                quant_stats: Optional[list] = None) -> torch.Tensor:
        """Final-norm hidden states (B, T, C).  ``remat`` checkpoints each
        layer: False/"none" keeps every activation, True/"full" recomputes
        the whole layer in the backward, "dots" keeps the projection
        products and recomputes the rest (``llama.apply``'s policies).
        ``quant_stats``: an empty list to collect, per layer, the column
        max |input| of each quantized product's site (SmoothQuant's
        calibration: 'attn_in', 'o_in', 'mlp_in', 'down_in'); it excludes
        remat."""
        cfg = self.cfg
        policy = remat_policy(remat)
        if quant_stats is not None and policy != "none":
            raise ValueError("quant_stats collection is incompatible with remat")
        x = self.embed(input_ids) if inputs_embeds is None else inputs_embeds
        T = x.shape[1]
        if T > cfg.max_seq_len:
            raise ValueError(f"sequence length {T} > max_seq_len {cfg.max_seq_len}")
        cos, sin = L.rope_frequencies(cfg.head_dim, cfg.max_seq_len,
                                      cfg.rope_theta, device=x.device)
        scaling = 1.0 if lora_cfg is None else lora_cfg.alpha / lora_cfg.rank
        for i, layer in enumerate(self.layers):
            args = (x, cos[:T], sin[:T], None if lora is None else lora.layers[i], scaling)
            if quant_stats is not None:
                quant_stats.append({})
                x = layer(*args, stats=quant_stats[-1])
            elif policy == "none" or not torch.is_grad_enabled():
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
    has it; otherwise both operands are cast to float32 first.  A quantized
    lm_head (``ops.quant``) gives its own output, in the hidden states'
    type, cast to float32.  On a mesh each tp rank computes its vocabulary
    columns, which are gathered over tp (the backward takes this rank's)."""
    if model.lm_head is not None and quant.is_quantized(model.lm_head):
        if model.mesh is None:
            return model.lm_head(hidden).float()
        head = M.fsdp_module(model.lm_head, "tp", model.mesh)
        return M.gather_from_tp(head(M.copy_to_tp(hidden, model.mesh)).float(), -1, model.mesh)
    w = model.embed_tokens.weight if model.cfg.tie_embeddings else model.lm_head.weight
    w = M.fsdp_weight(w, 1, model.mesh)
    lead = hidden.shape[:-1]
    h = M.copy_to_tp(hidden.reshape(-1, hidden.shape[-1]), model.mesh)
    if h.is_cuda and h.dtype != torch.float32 and _HAS_MM_OUT_DTYPE:
        out = _LogitsMM.apply(h, w)
    else:
        out = h.float() @ w.float().t()
    out = M.gather_from_tp(out, -1, model.mesh)
    return out.reshape(*lead, out.shape[-1])
