"""Synthetic batches matching the model's batch contract, the counterpart of
``llmseg_tpu.data.synthetic``: the same ``np.random.RandomState`` call
sequence, so one seed gives the same batch in both packages."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from llmseg_tpu_torch.config import LLMSegConfig
from llmseg_tpu_torch.device import require


def make_batch(cfg: LLMSegConfig, *, num_images: int = 1,
               rows_per_image: int = 1, text_len: int = 64, seed: int = 0,
               dtype=torch.float32, device="cuda") -> Dict[str, torch.Tensor]:
    """Random batch with valid structure: one image placeholder at position
    1, one [SEG] token near the end of each row, blobby proposal masks."""
    dev = require(device)
    rng = np.random.RandomState(seed)
    B = num_images
    R = num_images * rows_per_image
    K = cfg.max_proposals
    G = cfg.seg_grid
    lv = cfg.llava
    T = text_len

    ids = rng.randint(4, lv.llm.vocab_size - 4, size=(R, T))
    ids[:, T - 4] = cfg.seg_token_id
    labels = ids.copy()
    labels[:, : T // 2] = -100

    segs = (rng.rand(B, K, G, G) < 0.2).astype(np.float32)
    gt_iou = rng.rand(R, K).astype(np.float32)
    gt_iop = rng.rand(R, K).astype(np.float32)
    images_dino = rng.randn(B, cfg.dino.img_size, cfg.dino.img_size, 3)
    images_clip = rng.randn(B, lv.vision.img_size, lv.vision.img_size, 3)

    def t(x, dt):
        return torch.as_tensor(x).to(device=dev, dtype=dt)

    return {
        "images_dino": t(images_dino, dtype),
        "images_clip": t(images_clip, dtype),
        "input_ids": t(ids, torch.int32),
        "labels": t(labels, torch.int32),
        "image_pos": torch.ones((R,), dtype=torch.int32, device=dev),
        "row_to_image": t(np.repeat(np.arange(B), rows_per_image), torch.int32),
        "row_valid": torch.ones((R,), dtype=torch.bool, device=dev),
        "sam_segs": t(segs, dtype),
        "prop_valid": (torch.arange(K, device=dev) < max(K - 2, 1)).expand(B, K).contiguous(),
        "gt_ious": t(gt_iou, dtype),
        "gt_iops": t(gt_iop, dtype),
    }
