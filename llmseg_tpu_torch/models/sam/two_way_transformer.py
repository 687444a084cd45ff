"""SAM two-way transformer, the counterpart of
``llmseg_tpu.models.sam.two_way_transformer``: ``Attention``
(``attention_init`` / ``attention_apply``, which the selection head also
uses), ``TwoWayBlock`` (``block_apply``) and ``TwoWayTransformer``
(``apply``).  LayerNorm eps is 1e-6, as in the JAX package.

``TwoWayTransformer.forward`` routes as ``apply`` does: with ``impl="auto"``
large prompt batches on the card (``twoway_kernel.should_fuse``) go to
kernel I (``twoway_kernel.fused_twoway_apply``, the port of the Pallas
``_kernel``), ``"fused"`` forces it and ``"xla"`` takes the plain route.
The kernel is forward-only, so under autograd (grad enabled and a
parameter requiring grad) the plain route runs.  The mask decoder's plain
tail pins ``"xla"``, as the JAX ``_xla_tail`` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from llmseg_tpu_torch.models import layers as L
from llmseg_tpu_torch.ops import twoway_kernel
from llmseg_tpu_torch.ops.attention import NEG_INF, attention_plain


class Attention(nn.Module):
    """q/k/v/out projections to ``dim // downsample_rate``."""

    def __init__(self, dim: int, num_heads: int, downsample_rate: int = 1, *,
                 device=None, dtype=None):
        super().__init__()
        inner = dim // downsample_rate
        kw = dict(device=device, dtype=dtype)
        self.num_heads = num_heads
        self.q = nn.Linear(dim, inner, **kw)
        self.k = nn.Linear(dim, inner, **kw)
        self.v = nn.Linear(dim, inner, **kw)
        self.out = nn.Linear(inner, dim, **kw)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """q (B, Tq, C), k/v (B, Tk, C); key_mask (B, Tk) True = valid, which
        becomes a -1e9 additive bias."""
        B, Tq, _ = q.shape
        Tk = k.shape[1]
        qh = self.q(q).reshape(B, Tq, self.num_heads, -1)
        kh = self.k(k).reshape(B, Tk, self.num_heads, -1)
        vh = self.v(v).reshape(B, Tk, self.num_heads, -1)
        bias = None
        if key_mask is not None:
            bias = torch.where(key_mask, 0.0, NEG_INF)[:, None, None, :]
        out = attention_plain(qh, kh, vh, bias=bias)
        return self.out(out.reshape(B, Tq, -1))


class TwoWayBlock(nn.Module):
    """``block_apply``: token self attention, token-to-image, MLP (ReLU),
    image-to-token, each followed by a LayerNorm."""

    def __init__(self, dim: int, num_heads: int, mlp_dim: int, downsample_rate: int = 2,
                 skip_first_layer_pe: bool = False, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = Attention(dim, num_heads, 1, **kw)
        self.norm1 = L.LayerNorm(dim, **kw)
        self.cross_attn_t2i = Attention(dim, num_heads, downsample_rate, **kw)
        self.norm2 = L.LayerNorm(dim, **kw)
        self.mlp = L.MLP(dim, mlp_dim, act=torch.relu, **kw)
        self.norm3 = L.LayerNorm(dim, **kw)
        self.cross_attn_i2t = Attention(dim, num_heads, downsample_rate, **kw)
        self.norm4 = L.LayerNorm(dim, **kw)

    def forward(self, queries, keys, query_pe, key_pe, key_mask=None, query_mask=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries, key_mask=query_mask)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries, key_mask=query_mask)
        queries = self.norm1(queries)
        q = queries + query_pe
        k = keys + key_pe
        queries = self.norm2(queries + self.cross_attn_t2i(q, k, keys, key_mask=key_mask))
        queries = self.norm3(queries + self.mlp(queries))
        q = queries + query_pe
        keys = self.norm4(keys + self.cross_attn_i2t(k, q, queries, key_mask=query_mask))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, depth: int, dim: int, num_heads: int, mlp_dim: int, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_heads = num_heads
        self.layers = nn.ModuleList(
            TwoWayBlock(dim, num_heads, mlp_dim, skip_first_layer_pe=(i == 0), **kw)
            for i in range(depth))
        self.final_attn = Attention(dim, num_heads, 2, **kw)
        self.norm_final = L.LayerNorm(dim, **kw)

    def forward(self, image_embedding: torch.Tensor, image_pe: torch.Tensor,
                point_embedding: torch.Tensor, impl: str = "auto"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``apply``: image_embedding (B, S, S, C); image_pe (S, S, C) or
        (1 | B, S, S, C); point_embedding (B, N, C).  Returns (queries
        (B, N, C), keys (B, S*S, C)); from kernel I in the image dtype."""
        B, Hs, Ws, C = image_embedding.shape
        if impl not in ("auto", "fused", "xla"):
            raise ValueError(f"impl must be 'auto', 'fused' or 'xla', got {impl!r}")
        grad = torch.is_grad_enabled() and any(p.requires_grad for p in self.parameters())
        if not grad and (impl == "fused" or (impl == "auto" and twoway_kernel.should_fuse(
                B, Hs * Ws, image_pe, image_embedding.device))):
            return twoway_kernel.fused_twoway_apply(self, image_embedding, image_pe,
                                                    point_embedding, self.num_heads)
        keys = image_embedding.reshape(B, Hs * Ws, C)
        key_pe = image_pe.reshape(-1, Hs * Ws, C).to(keys.dtype)
        queries = point_embedding.to(keys.dtype)
        query_pe = queries
        for layer in self.layers:
            queries, keys = layer(queries, keys, query_pe, key_pe)
        q = queries + query_pe
        k = keys + key_pe
        queries = self.norm_final(queries + self.final_attn(q, k, keys))
        return queries, keys
