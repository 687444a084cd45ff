"""Mask-selection transformer, the counterpart of
``llmseg_tpu.models.selection_head``: two two-way blocks fuse the K proposal
embeddings (queries) with the [SEG] text embedding (one key per row), then a
final cross attention and LayerNorm, the IoP head and the embedding head.
Proposals are padded to K with a validity mask that every attention over
proposals turns into a -1e9 bias.  LayerNorm eps is 1e-5 throughout."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from llmseg_tpu_torch.config import SelectionHeadConfig
from llmseg_tpu_torch.models import layers as L
from llmseg_tpu_torch.models.sam.two_way_transformer import Attention

EPS = 1e-5


class SelectionBlock(nn.Module):
    def __init__(self, cfg: SelectionHeadConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d, h = cfg.dim, cfg.num_heads
        self.self_attn = Attention(d, h, 1, **kw)
        self.norm1 = L.LayerNorm(d, EPS, **kw)
        self.cross_t2i = Attention(d, h, 1, **kw)
        self.norm2 = L.LayerNorm(d, EPS, **kw)
        self.mlp = L.MLP(d, cfg.mlp_dim, act=torch.relu, **kw)
        self.norm3 = L.LayerNorm(d, EPS, **kw)
        self.cross_i2t = Attention(d, h, 1, **kw)
        self.norm4 = L.LayerNorm(d, EPS, **kw)

    def forward(self, queries, keys, prop_valid):
        """queries (R, K, C) proposals; keys (R, 1, C) text."""
        q = self.self_attn(queries, queries, queries, key_mask=prop_valid)
        queries = self.norm1(queries + q)
        q = self.cross_t2i(queries, keys, keys)
        queries = self.norm2(queries + q)
        queries = self.norm3(queries + self.mlp(queries))
        k = self.cross_i2t(keys, queries, queries, key_mask=prop_valid)
        keys = self.norm4(keys + k)
        return queries, keys


class SelectionHead(nn.Module):
    def __init__(self, cfg: SelectionHeadConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.dim
        self.cfg = cfg
        self.text_fc1 = nn.Linear(cfg.llm_dim, cfg.llm_dim, **kw)
        self.text_fc2 = nn.Linear(cfg.llm_dim, d, **kw)
        self.dino_conv = nn.Linear(cfg.dino_dim, d, **kw)
        self.blocks = nn.ModuleList(SelectionBlock(cfg, **kw)
                                    for _ in range(cfg.depth))
        self.final_attn = Attention(d, cfg.num_heads, 1, **kw)
        self.norm_final = L.LayerNorm(d, EPS, **kw)
        self.iou_head = L.MLPStack([d, cfg.iou_head_hidden, 1],
                                   final_act=torch.sigmoid, **kw)
        self.embedding_head = L.MLPStack([d, cfg.embed_head_hidden, d], **kw)

    def project_text(self, hidden: torch.Tensor) -> torch.Tensor:
        """text_hidden_fcs: LLM hidden -> dim."""
        return self.text_fc2(torch.relu(self.text_fc1(hidden)))

    def project_dino(self, feats: torch.Tensor) -> torch.Tensor:
        """The 1x1 DINOv2 projection as a linear over (..., dino_dim)."""
        return self.dino_conv(feats)

    def forward(self, prop_embeds: torch.Tensor, text_embed: torch.Tensor,
                prop_valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """prop_embeds (R, K, C), text_embed (R, C), prop_valid (R, K) bool.
        Returns similarity (R, K) cosine, pred_iou (R, K) in [0, 1] and
        seg_features (R, K, C); invalid proposals get -1 and 0."""
        queries, keys = prop_embeds, text_embed[:, None, :]
        for blk in self.blocks:
            queries, keys = blk(queries, keys, prop_valid)
        queries = self.norm_final(queries + self.final_attn(queries, keys, keys))
        pred_iou = self.iou_head(queries)[..., 0]
        seg_features = self.embedding_head(queries)
        t = text_embed.float()
        s = seg_features.float()
        t = t / (torch.linalg.vector_norm(t, dim=-1, keepdim=True) + 1e-8)
        s = s / (torch.linalg.vector_norm(s, dim=-1, keepdim=True) + 1e-8)
        similarity = torch.einsum("rkd,rd->rk", s, t)
        if prop_valid is not None:
            similarity = torch.where(prop_valid, similarity, -1.0)
            pred_iou = torch.where(prop_valid, pred_iou, 0.0)
        return similarity, pred_iou, seg_features


def mask_pooling(features: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(R, HW, C) features x (R, K, HW) soft mask weights -> (R, K, C):
    weights @ features / sum(weights), float32 accumulation."""
    pooled = torch.einsum("rkh,rhd->rkd", weights.float(), features.float())
    denom = weights.sum(-1, keepdim=True).float() + 1e-8
    return (pooled / denom).to(features.dtype)
