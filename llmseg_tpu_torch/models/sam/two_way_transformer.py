"""SAM-style attention, the part of ``llmseg_tpu.models.sam.two_way_transformer``
the selection head uses: ``attention_init`` / ``attention_apply`` as one
module.  It always takes the plain attention path, as the JAX function calls
``attention_xla`` directly."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

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
