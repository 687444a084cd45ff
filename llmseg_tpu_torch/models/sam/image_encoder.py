"""SAM ViT image encoder, the counterpart of
``llmseg_tpu.models.sam.image_encoder``: patch embedding, absolute position
embedding, windowed and global blocks with the decomposed relative-position
bias, and the conv neck to ``out_chans``.  NHWC throughout, as in the JAX
package.

Attention with the rel-pos bias takes kernels F (windows, T <= 512) and E
(global grids) for CUDA tensors, through
``ops.relpos_attention.relpos_flash_attention``; on the CPU it materialises
the bias and runs the plain attention, which is what the JAX function does
off the TPU.  Zero tokens that pad a window to a multiple of the window
size take part in the attention, with no key mask, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from llmseg_tpu_torch.config import SamEncoderConfig
from llmseg_tpu_torch.models import layers as L
from llmseg_tpu_torch.ops.attention import attention_plain
from llmseg_tpu_torch.ops.relpos_attention import (decomposed_rel_pos_bias,
                                                    relpos_flash_attention)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, use_rel_pos: bool, input_size: int,
                 *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_heads = num_heads
        self.use_rel_pos = use_rel_pos
        self.qkv = nn.Linear(dim, 3 * dim, **kw)
        self.proj = nn.Linear(dim, dim, **kw)
        if use_rel_pos:
            hd = dim // num_heads
            self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size - 1, hd, **kw))
            self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size - 1, hd, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> (B, H, W, C); H == W for the rel-pos bias."""
        B, Hs, Ws, C = x.shape
        T = Hs * Ws
        qkv = self.qkv(x.reshape(B, T, C)).reshape(B, T, 3, self.num_heads, -1)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if self.use_rel_pos and Hs == Ws and x.is_cuda:
            out = relpos_flash_attention(q, k, v, self.rel_pos_h, self.rel_pos_w, Hs)
        else:
            bias = None
            if self.use_rel_pos:   # from the UNSCALED q
                bias = decomposed_rel_pos_bias(q.transpose(1, 2), self.rel_pos_h,
                                               self.rel_pos_w, Hs)
            out = attention_plain(q, k, v, bias=bias)
        return self.proj(out.reshape(B, Hs, Ws, C))


def window_partition(x: torch.Tensor, w: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(B, H, W, C) -> (B*nW, w, w, C), H and W zero-padded to multiples of w."""
    B, H, W, C = x.shape
    pad_h, pad_w = (-H) % w, (-W) % w
    if pad_h or pad_w:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.reshape(B, Hp // w, w, Wp // w, w, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w, w, C), (Hp, Wp)


def window_unpartition(x: torch.Tensor, w: int, hp_wp, hw) -> torch.Tensor:
    Hp, Wp = hp_wp
    H, W = hw
    B = x.shape[0] // ((Hp // w) * (Wp // w))
    x = x.reshape(B, Hp // w, Wp // w, w, w, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, Hp, Wp, -1)[:, :H, :W]


class Block(nn.Module):
    def __init__(self, cfg: SamEncoderConfig, layer_idx: int, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.window = (cfg.window_size
                       if layer_idx not in cfg.global_attn_indexes and cfg.window_size > 0
                       else 0)
        self.norm1 = L.LayerNorm(cfg.embed_dim, **kw)
        self.attn = Attention(cfg.embed_dim, cfg.num_heads, cfg.use_rel_pos,
                              self.window or cfg.grid, **kw)
        self.norm2 = L.LayerNorm(cfg.embed_dim, **kw)
        self.mlp = L.MLP(cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio), **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        x = self.norm1(x)
        if self.window:
            H, W = x.shape[1], x.shape[2]
            x, hp_wp = window_partition(x, self.window)
            x = window_unpartition(self.attn(x), self.window, hp_wp, (H, W))
        else:
            x = self.attn(x)
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class Neck(nn.Module):
    def __init__(self, cfg: SamEncoderConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.conv1 = L.Conv2d(cfg.embed_dim, cfg.out_chans, 1, bias=False, **kw)
        self.ln1 = L.LayerNorm2d(cfg.out_chans, **kw)
        self.conv2 = L.Conv2d(cfg.out_chans, cfg.out_chans, 3, bias=False, **kw)
        self.ln2 = L.LayerNorm2d(cfg.out_chans, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ln2(self.conv2(self.ln1(self.conv1(x))))


class ImageEncoder(nn.Module):
    def __init__(self, cfg: SamEncoderConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.patch_embed = L.PatchEmbed(cfg.patch_size, cfg.in_chans, cfg.embed_dim, **kw)
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.grid, cfg.grid, cfg.embed_dim, **kw))
        self.blocks = nn.ModuleList(Block(cfg, i, **kw) for i in range(cfg.depth))
        self.neck = Neck(cfg, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, img, img, 3) preprocessed -> (B, grid, grid, out_chans)."""
        x = self.patch_embed(x.to(self.patch_embed.weight.dtype)) + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        return self.neck(x)
