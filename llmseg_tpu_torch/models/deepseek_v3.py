"""DeepSeek-V3's decoder, as Kimi-VL-A3B-Instruct's language model, for
inference: the port's own (the JAX package has no counterpart).

It keeps ``Llama``'s contract: :meth:`DeepseekV3.embed` and
``forward(inputs_embeds=...)`` give the final-norm hidden states, so
``Llava`` builds it from a :class:`~llmseg_tpu_torch.config.DeepseekV3Config`
and ``llmseg.forward`` / ``predict`` run it unchanged.  Per layer, for x of
(N, d):

* multi-head latent attention (no q compression): q = RMSNorm(x) W_q, split
  per head into [q_nope | q_pe]; [c_kv | k_pe] = RMSNorm(x) W_kv_a; c_kv
  normed again (``kv_norm``, eps 1e-6, the published code's default) and
  expanded per head to [k_nope | v] = c_kv W_kv_b; q_pe and the one k_pe
  that all heads share are rotated (:func:`apply_rope_pairs`); causal
  softmax attention of q = [q_nope | q_pe] against k = [k_nope | k_pe] with
  scale (qk head dim)^-1/2, on the card through kernel A at head dims
  (192, 128), one launch a layer; o through W_o.
* the first ``first_k_dense_replace`` layers: a SwiGLU MLP.
* the rest: :class:`MoE`.  The router's sigmoid scores s are float32; the
  experts chosen are the top k of s + the correction bias, their weights
  s at the chosen experts over their sum (+ 1e-20) times
  ``routed_scaling_factor``.  Every (token, expert) pair is computed: no
  capacity, nothing dropped.  On every device the layer runs without a
  host sync: the pairs sorted by expert, the groups' ends found on the
  device, the tokens gathered, two grouped products (gate and up fused,
  then down: ``torch._grouped_mm``), then the combine (``ops/moe.py``):
  each token's k rows read back through the inverse of the sort's order,
  weighted and summed in float32 with the shared experts' row, one
  rounding; on the card one launch of ``csrc/moe_combine.cu``.

On the card the layers run as CUDA graphs, one for each half of a layer
(:class:`_LayerGraphs`): the host launches a layer in two replays where
it launched about a hundred operations, and so stays ahead of the card.

Training, LoRA, SmoothQuant statistics, W8A8, the mesh and decoding with a
latent cache are not ported for this decoder (``DeepseekV3Config.unported``):
each raises (``config.require_ported``).  Spans
``llm.mla`` and ``llm.moe`` time a layer's attention and MoE block on the
host; counters ``moe.routed_pairs``, ``moe.grouped_gemms`` and
``moe.combine_kernels`` count the pairs, the grouped products and the
combines through the kernel (``utils/profiling.py``).
"""

from __future__ import annotations

import contextlib
import functools
import weakref
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from llmseg_tpu_torch.config import DeepseekV3Config, require_ported
from llmseg_tpu_torch.models import layers as L
from llmseg_tpu_torch.ops.attention import attention
from llmseg_tpu_torch.ops.kernels import capture, replay_or_capture, replayed, stamp, warm_up
from llmseg_tpu_torch.ops.moe import Routed, combine
from llmseg_tpu_torch.utils import profiling


def apply_rope_pairs(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """DeepSeek-V3's RoPE on x (B, T, H, D): each D-vector's interleaved
    pairs (x0, x1), (x2, x3), ... permuted to halves [x0, x2, ... | x1, x3,
    ...], then the half rotation of ``layers.apply_rope``."""
    x = x.unflatten(-1, (-1, 2)).transpose(-1, -2).flatten(-2)
    return L.apply_rope(x, cos, sin)


class SwiGLU(nn.Module):
    def __init__(self, dim: int, hidden: int, *, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        self.gate = nn.Linear(dim, hidden, **kw)
        self.up = nn.Linear(dim, hidden, **kw)
        self.down = nn.Linear(hidden, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(F.silu(self.gate(x)) * self.up(x))


class MLA(nn.Module):
    """Multi-head latent attention without q compression."""

    def __init__(self, cfg: DeepseekV3Config, *, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        H, d = cfg.num_heads, cfg.hidden_size
        self.cfg = cfg
        self.q = nn.Linear(d, H * cfg.qk_head_dim, **kw)
        self.kv_a = nn.Linear(d, cfg.kv_lora_rank + cfg.qk_rope_head_dim, **kw)
        self.kv_norm = L.RMSNorm(cfg.kv_lora_rank, cfg.kv_norm_eps, device=device, dtype=dtype)
        self.kv_b = nn.Linear(cfg.kv_lora_rank, H * (cfg.qk_nope_head_dim + cfg.v_head_dim), **kw)
        self.o = nn.Linear(H * cfg.v_head_dim, d, **kw)

    def forward(self, h: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, T, _ = h.shape
        H, nope, rope = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        q_nope, q_pe = self.q(h).view(B, T, H, -1).split([nope, rope], -1)
        c_kv, k_pe = self.kv_a(h).split([cfg.kv_lora_rank, rope], -1)
        k_nope, v = self.kv_b(self.kv_norm(c_kv)).view(B, T, H, -1).split(
            [nope, cfg.v_head_dim], -1)
        q = torch.cat([q_nope, apply_rope_pairs(q_pe, cos, sin)], -1)
        k_pe = apply_rope_pairs(k_pe[:, :, None, :], cos, sin)
        k = torch.cat([k_nope, k_pe.expand(B, T, H, rope)], -1)
        o = attention(q, k, v, causal=True)
        return self.o(o.reshape(B, T, H * cfg.v_head_dim))


class Router(nn.Module):
    """The sigmoid router with its correction bias (``noaux_tc``, one group).
    The bias is a float32 buffer whatever the model's dtype, as DeepSeek-V3's
    inference code keeps it: bf16's spacing near 1 (2^-7) is as wide as
    the gaps between the scores it decides."""

    def __init__(self, cfg: DeepseekV3Config, *, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.weight = nn.Parameter(torch.empty(cfg.n_routed_experts, cfg.hidden_size,
                                               device=device, dtype=dtype))
        self.register_buffer("correction_bias", torch.zeros(cfg.n_routed_experts,
                                                            device=device, dtype=torch.float32))

    def forward(self, x: torch.Tensor):
        """x (N, d) -> (experts (N, k) int64, weights (N, k) float32)."""
        s = torch.sigmoid(F.linear(x.float(), self.weight.float()))
        idx = torch.topk(s + self.correction_bias, self.cfg.num_experts_per_tok,
                         dim=-1).indices
        w = s.gather(1, idx)
        return idx, w / (w.sum(-1, keepdim=True) + 1e-20) * self.cfg.routed_scaling_factor


class Experts(nn.Module):
    """The routed experts' weights, stacked in two matrices of
    ``nn.Linear`` weights: ``gate_up`` (E 2I, d), expert e's gate rows then
    its up rows from row 2I e, and ``down`` (E d, I), expert e's from row
    d e.  The grouped products read them as (E, 2I, d) and (E, d, I)."""

    def __init__(self, cfg: DeepseekV3Config, *, device=None, dtype=None):
        super().__init__()
        E, I, d = cfg.n_routed_experts, cfg.moe_intermediate_size, cfg.hidden_size
        kw = dict(device=device, dtype=dtype)
        self.n = E
        self.gate_up = nn.Parameter(torch.empty(E * 2 * I, d, **kw))
        self.down = nn.Parameter(torch.empty(E * d, I, **kw))

    def forward(self, x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> Routed:
        """E_i(x) for each token's experts idx (N, k) on x (N, d): the rows in
        expert order, with the sort's order and the weights w (N, k) that
        ``ops.moe.combine`` sums them with."""
        k = idx.shape[1]
        E, I = self.n, self.down.shape[1]
        gate_up, down = self.gate_up.view(E, 2 * I, -1), self.down.view(E, -1, I)
        experts, order = torch.sort(idx.reshape(-1), stable=True)
        ends = torch.searchsorted(experts, torch.arange(E, device=x.device), right=True)
        ends = ends.to(torch.int32)                   # each expert's last pair + 1
        xs = x.index_select(0, order // k)            # the pairs' tokens, by expert
        gu = torch._grouped_mm(xs, gate_up.transpose(1, 2), offs=ends)
        y = torch._grouped_mm(F.silu(gu[:, :I]) * gu[:, I:], down.transpose(1, 2), offs=ends)
        return Routed(y, order, w)


class MoE(nn.Module):
    """Routed experts plus the shared ones.  ``last_experts`` holds the
    experts chosen in the last forward, (N, k) on the device, kept with no
    sync: the tensor the router made, or under a CUDA graph a copy of it."""

    def __init__(self, cfg: DeepseekV3Config, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.router = Router(cfg, **kw)
        self.experts = Experts(cfg, **kw)
        self.shared = SwiGLU(cfg.hidden_size, cfg.moe_intermediate_size * cfg.n_shared_experts,
                             **kw)
        self.last_experts: Optional[torch.Tensor] = None

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        x = h.reshape(-1, h.shape[-1])
        idx, w = self.router(x)
        self.last_experts = idx
        return combine(self.experts(x, idx, w), self.shared(x)).view(h.shape)

    def count(self) -> None:
        """The counters of the last forward: its (token, expert) pairs, its
        two grouped products and, on the card, its combine through the
        kernel (``ops.moe.combine`` launches it there or raises)."""
        profiling.count("moe.grouped_gemms", 2)
        profiling.count("moe.routed_pairs", self.last_experts.numel())
        if self.last_experts.is_cuda:
            profiling.count("moe.combine_kernels")


class DeepseekV3Layer(nn.Module):
    def __init__(self, cfg: DeepseekV3Config, dense: bool, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.input_norm = L.RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        self.attn = MLA(cfg, **kw)
        self.post_norm = L.RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        self.mlp = (SwiGLU(cfg.hidden_size, cfg.intermediate_size, **kw) if dense
                    else MoE(cfg, **kw))

    def halves(self, cos, sin):
        """The layer as two steps of x: (span name or None, step, the MoE
        block or None), its attention and then its MLP or MoE block."""
        moe = self.mlp if isinstance(self.mlp, MoE) else None
        return [("llm.mla", lambda x: x + self.attn(self.input_norm(x), cos, sin), None),
                ("llm.moe" if moe else None, lambda x: x + self.mlp(self.post_norm(x)), moe)]

    def forward(self, x, cos, sin):
        for name, step, moe in self.halves(cos, sin):
            with profiling.span(name) if name else contextlib.nullcontext():
                x = step(x)
                if moe is not None:
                    moe.count()
        return x


class _LayerGraphs:
    """A decoder's layers as CUDA graphs at one input shape, dtype and
    device: one graph for each half of a layer (``DeepseekV3Layer.halves``),
    captured in order into one memory pool, each half's input the output of
    the half before, so a replay copies in only the first input.  It is a
    sequence and not one ``StaticGraph`` because the host works between
    the halves' replays, as the eager path does: the spans, the MoE
    counters, a copy of each MoE layer's chosen experts (the captured index
    tensor is the same storage at every replay), and the launches of the
    port's kernels (kernel A and the MoE combine launch through ctypes on
    the capturing stream, so the graphs hold them).  The weights' storage
    is stamped."""

    def __init__(self, model: "DeepseekV3", x: torch.Tensor):
        self.tensors = list(model.parameters()) + list(model.buffers())
        self.stamp = stamp(self.tensors)
        cfg = model.cfg
        with torch.inference_mode(False), torch.no_grad():
            cos, sin = L.rope_frequencies(cfg.qk_rope_head_dim, x.shape[1], cfg.rope_theta,
                                          device=x.device)
            self.x = torch.empty(x.shape, dtype=x.dtype, device=x.device)
            self.x.copy_(x)

            def layers():
                h = self.x
                for layer in model.layers:
                    h = layer(h, cos, sin)
                return h, [(m, m.last_experts) for m in model.moe_layers()]

            self.first, routes = warm_up(layers, x.device)
            pool, h, self.halves = torch.cuda.graph_pool_handle(), self.x, []
            for layer in model.layers:
                for name, step, moe in layer.halves(cos, sin):
                    graph, h, launches = capture(functools.partial(step, h), pool=pool)
                    experts = None if moe is None else moe.last_experts
                    self.halves.append((name, graph, launches, moe, experts))
            self.out, self.rope = h, (cos, sin)   # the graphs read cos and sin
            for m, idx in routes:   # the first call's choices, not the capture's
                m.last_experts = idx

    def current(self) -> bool:
        return self.stamp == stamp(self.tensors)

    def replay(self, x: torch.Tensor) -> torch.Tensor:
        """The last layer's output for ``x``, in the graphs' own storage."""
        self.x.copy_(x)
        for name, graph, launches, moe, experts in self.halves:
            with profiling.span(name) if name else contextlib.nullcontext():
                graph.replay()
                if moe is not None:
                    moe.last_experts = experts.clone()
                    moe.count()
            replayed(launches)
        return self.out


# decoder -> {(shape, dtype, device): _LayerGraphs}; dropped with the decoder
_GRAPHS = weakref.WeakKeyDictionary()


class DeepseekV3(nn.Module):
    def __init__(self, cfg: DeepseekV3Config, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.layers = nn.ModuleList(DeepseekV3Layer(cfg, i < cfg.first_k_dense_replace, **kw)
                                    for i in range(cfg.num_layers))
        self.norm = L.RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        self.lm_head = (None if cfg.tie_embeddings else
                        nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False, **kw))

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.embed_tokens(input_ids)

    def moe_layers(self):
        return [layer.mlp for layer in self.layers if isinstance(layer.mlp, MoE)]

    def forward(self, *, input_ids: Optional[torch.Tensor] = None,
                inputs_embeds: Optional[torch.Tensor] = None, lora=None, lora_cfg=None,
                remat=False, quant_stats: Optional[list] = None) -> torch.Tensor:
        """Final-norm hidden states (B, T, C), under ``torch.no_grad`` or
        ``torch.inference_mode``; ``Llama.forward``'s other arguments are
        refused unless empty."""
        if lora is not None or lora_cfg is not None:
            require_ported(self.cfg, "lora")
        if quant_stats is not None:
            require_ported(self.cfg, "quant_stats")
        if remat not in (False, None, "none") or torch.is_grad_enabled():
            require_ported(self.cfg, "training")
        cfg = self.cfg
        x = self.embed(input_ids) if inputs_embeds is None else inputs_embeds
        T = x.shape[1]
        if T > cfg.max_seq_len:
            raise ValueError(f"sequence length {T} > max_seq_len {cfg.max_seq_len}")
        if x.is_cuda:
            return self.norm(self._graphed(x))
        cos, sin = L.rope_frequencies(cfg.qk_rope_head_dim, cfg.max_seq_len, cfg.rope_theta,
                                      device=x.device)
        for layer in self.layers:
            x = layer(x, cos[:T], sin[:T])
        return self.norm(x)

    def _graphed(self, x: torch.Tensor) -> torch.Tensor:
        """The layers on the card, as CUDA graphs for each input shape, dtype
        and device: the first call at one runs them eagerly (the warm-up)
        and captures them; later calls copy ``x`` in and replay them with no
        host sync.  They are captured again where a weight has moved to
        other storage; in-place changes to the weights are read by every
        replay."""
        return replay_or_capture(_GRAPHS, self, (tuple(x.shape), x.dtype, x.device),
                                 functools.partial(_LayerGraphs, self), x)
