"""SAM prompt encoder, the counterpart of
``llmseg_tpu.models.sam.prompt_encoder``: points, boxes, masks and text
embeddings into sparse (B, N, D) and dense (B, S, S, D) embeddings.

Point labels: -10 padding (embeds to zero), -1 "not a point" (the pad
point appended to point prompts without a box), 0 negative, 1 positive,
2 / 3 box corners.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from llmseg_tpu_torch.config import SamPromptConfig
from llmseg_tpu_torch.models import layers as L


class MaskDownscale(nn.Module):
    def __init__(self, cfg: SamPromptConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        c = cfg.mask_in_chans
        self.conv1 = L.Conv2d(1, c // 4, 2, **kw)
        self.ln1 = L.LayerNorm2d(c // 4, **kw)
        self.conv2 = L.Conv2d(c // 4, c, 2, **kw)
        self.ln2 = L.LayerNorm2d(c, **kw)
        self.conv3 = L.Conv2d(c, cfg.embed_dim, 1, **kw)

    def forward(self, masks: torch.Tensor) -> torch.Tensor:
        """(B, 4S, 4S, 1) -> (B, S, S, D)."""
        x = masks.to(self.conv1.weight.dtype)
        x = L.gelu_tanh(self.ln1(self.conv1(x, stride=2, padding="VALID")))
        x = L.gelu_tanh(self.ln2(self.conv2(x, stride=2, padding="VALID")))
        return self.conv3(x)


class PromptEncoder(nn.Module):
    def __init__(self, cfg: SamPromptConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.embed_dim
        self.cfg = cfg
        self.pe = L.PositionEmbeddingRandom(d // 2, **kw)
        # 0: negative point, 1: positive point, 2: box top-left, 3: bottom-right
        self.point_embeddings = nn.Parameter(torch.empty(4, d, **kw))
        self.not_a_point_embed = nn.Parameter(torch.empty(1, d, **kw))
        self.no_mask_embed = nn.Parameter(torch.empty(1, d, **kw))
        self.mask_downscale = MaskDownscale(cfg, **kw)

    def embed_points(self, points: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """points (B, N, 2) pixels, labels (B, N) -> (B, N, D) float32."""
        pe = self.pe((points.float() + 0.5) / self.cfg.input_image_size)
        lab = labels[..., None]
        pw = self.point_embeddings.float()
        emb = pe
        for i in range(4):
            emb = emb + torch.where(lab == i, pw[i], 0.0)
        emb = torch.where(lab == -1, self.not_a_point_embed[0].float(), emb)
        return torch.where(lab == -10, 0.0, emb)

    def dense_pe(self, size: int) -> torch.Tensor:
        """Positional encoding of the image-embedding grid, (size, size, D)."""
        return L.position_grid(self.pe, size)

    def forward(self, *, points: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None,
                boxes: Optional[torch.Tensor] = None,
                masks: Optional[torch.Tensor] = None,
                text_embeds: Optional[torch.Tensor] = None,
                batch: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (sparse (B, N, D), dense (B, S, S, D)).  Boxes (B, 4) xyxy
        become two corner points; point prompts without a box get a pad
        point with label -1."""
        d = self.cfg.embed_dim
        dev = self.point_embeddings.device
        sparse = []
        B = batch
        if points is not None:
            if labels is None:
                raise ValueError("points need labels")
            B = points.shape[0]
            if boxes is None:
                points = torch.cat([points, torch.zeros(B, 1, 2, dtype=points.dtype,
                                                        device=points.device)], 1)
                labels = torch.cat([labels, -torch.ones(B, 1, dtype=labels.dtype,
                                                        device=labels.device)], 1)
            sparse.append(self.embed_points(points, labels))
        if boxes is not None:
            B = boxes.shape[0]
            corner_labels = torch.tensor([2, 3], device=boxes.device).expand(B, 2)
            sparse.append(self.embed_points(boxes.reshape(-1, 2, 2), corner_labels))
        if text_embeds is not None:
            B = text_embeds.shape[0]
            sparse.append(text_embeds)
        if sparse:
            dt = torch.promote_types(sparse[0].dtype, sparse[-1].dtype)
            sparse_out = torch.cat([x.to(dt) for x in sparse], 1)
        else:
            sparse_out = torch.zeros(B, 0, d, device=dev)
        if masks is not None:
            dense = self.mask_downscale(masks)
        else:
            s = self.cfg.image_embedding_size
            dense = self.no_mask_embed.reshape(1, 1, 1, d).expand(B, s, s, d)
        return sparse_out, dense
