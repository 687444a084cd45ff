"""Generic ViT for both frozen towers, the counterpart of
``llmseg_tpu.models.vit``: the CLIP ViT-L/14 vision tower (quick-gelu,
pre-LN, layer -2, patch tokens) and DINOv2 ViT-L/14 (LayerScale, tanh-GELU
as in the JAX package, final norm, patch tokens).  Tokens are (B, T, C) with
the CLS token at index 0; attention goes through ``ops.attention.attention``,
which sends DINOv2@896's 4097-token layers to kernel B on the card."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from llmseg_tpu_torch.config import ViTConfig
from llmseg_tpu_torch.models import layers as L
from llmseg_tpu_torch.ops.attention import attention


class ViTAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_heads = num_heads
        self.q = nn.Linear(dim, dim, **kw)
        self.k = nn.Linear(dim, dim, **kw)
        self.v = nn.Linear(dim, dim, **kw)
        self.out = nn.Linear(dim, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, C = x.shape
        q = self.q(x).reshape(B, T, self.num_heads, -1)
        k = self.k(x).reshape(B, T, self.num_heads, -1)
        v = self.v(x).reshape(B, T, self.num_heads, -1)
        return self.out(attention(q, k, v).reshape(B, T, C))


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.hidden_size
        act = L.quick_gelu if cfg.use_quick_gelu else L.gelu_tanh
        self.norm1 = L.LayerNorm(d, cfg.ln_eps, **kw)
        self.attn = ViTAttention(d, cfg.num_heads, **kw)
        self.norm2 = L.LayerNorm(d, cfg.ln_eps, **kw)
        self.mlp = L.MLP(d, int(d * cfg.mlp_ratio), act=act, **kw)
        # LayerScale diagonals; fold_layerscale_inplace removes them
        self.ls1 = nn.Parameter(torch.full((d,), 1e-5, **kw)) if cfg.layerscale else None
        self.ls2 = nn.Parameter(torch.full((d,), 1e-5, **kw)) if cfg.layerscale else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.attn(self.norm1(x))
        if self.ls1 is not None:
            h = h * self.ls1
        x = x + h
        h = self.mlp(self.norm2(x))
        if self.ls2 is not None:
            h = h * self.ls2
        return x + h


class ViT(nn.Module):
    def __init__(self, cfg: ViTConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        d = cfg.hidden_size
        n_tok = cfg.num_patches + cfg.num_prefix_tokens
        # CLIP's patch convolution has no bias
        self.patch_embed = L.PatchEmbed(cfg.patch_size, 3, d,
                                        bias=not cfg.layernorm_pre, **kw)
        self.pos_embed = nn.Parameter(torch.zeros(1, n_tok, d, **kw))
        self.blocks = nn.ModuleList(ViTBlock(cfg, **kw) for _ in range(cfg.depth))
        self.norm = L.LayerNorm(d, cfg.ln_eps, **kw)
        self.cls_token = (nn.Parameter(torch.zeros(1, 1, d, **kw))
                          if cfg.use_class_embedding else None)
        self.pre_norm = L.LayerNorm(d, cfg.ln_eps, **kw) if cfg.layernorm_pre else None

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, 1+N, C) tokens with CLS and positions; the cls
        row is formed after the position add, as in the JAX package."""
        B = x.shape[0]
        d = self.cfg.hidden_size
        tok = self.patch_embed(x.to(self.patch_embed.weight.dtype)).reshape(B, -1, d)
        if self.cls_token is not None:
            tok = tok + self.pos_embed[:, 1:]
            cls = self.cls_token + self.pos_embed[:, :1]
            tok = torch.cat([cls.expand(B, 1, d), tok], dim=1)
        else:
            tok = tok + self.pos_embed
        if self.pre_norm is not None:
            tok = self.pre_norm(tok)
        return tok

    def forward(self, x: torch.Tensor, num_layers: Optional[int] = None,
                final_norm: bool = True) -> torch.Tensor:
        """Run ``num_layers`` blocks (default all); returns (B, 1+N, C)."""
        tok = self.embed(x)
        n = self.cfg.depth if num_layers is None else num_layers
        for blk in self.blocks[:n]:
            tok = blk(tok)
        if final_norm:
            tok = self.norm(tok)
        return tok


def fold_layerscale_inplace(tower: ViT) -> ViT:
    """Fold DINOv2's LayerScale into the producing projections,
    (o W_o^T + b_o) * ls1 == o (ls1 * W_o)^T + ls1 * b_o (and ls2 into fc2),
    in float32 with one rounding; the ls parameters are removed.  In place."""
    with torch.no_grad():
        for blk in tower.blocks:
            for name, proj in (("ls1", blk.attn.out), ("ls2", blk.mlp.fc2)):
                ls = getattr(blk, name)
                if ls is None:
                    continue
                lsf = ls.float()
                proj.weight.copy_(proj.weight.float() * lsf[:, None])
                if proj.bias is not None:
                    proj.bias.copy_(proj.bias.float() * lsf)
                setattr(blk, name, None)
    return tower


def clip_features(tower: ViT, x: torch.Tensor, select_layer: int = -2) -> torch.Tensor:
    """CLIP feature_select: hidden state at ``select_layer`` (HF indexing),
    patch tokens only, no final norm.  (B, H, W, 3) -> (B, N, C)."""
    cfg = tower.cfg
    tok = tower(x, num_layers=cfg.depth + select_layer + 1, final_norm=False)
    return tok[:, cfg.num_prefix_tokens:]


def dino_patch_features(tower: ViT, x: torch.Tensor) -> torch.Tensor:
    """DINOv2 x_norm_patchtokens: all blocks + final norm, patch tokens.
    (B, H, W, 3) -> (B, N, C)."""
    tok = tower(x)
    return tok[:, tower.cfg.num_prefix_tokens:]
