"""Box NMS, the counterpart of ``llmseg_tpu.ops.nms``: the exact greedy
result by fixpoint iteration over the IoU matrix, on the boxes' device.
Sorts are stable, so ties keep index order as in the JAX package."""

from __future__ import annotations

from typing import Optional

import torch


def box_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes: (N, 4) x (M, 4) -> (N, M) float32."""
    a, b = boxes_a.float(), boxes_b.float()
    area_a = (a[:, 2] - a[:, 0]).clamp_min(0) * (a[:, 3] - a[:, 1]).clamp_min(0)
    area_b = (b[:, 2] - b[:, 0]).clamp_min(0) * (b[:, 3] - b[:, 1]).clamp_min(0)
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy NMS: keep (N,) bool in the original order.  Invalid entries are
    never kept and never suppress; a box is kept iff no higher-scoring kept
    box overlaps it above the threshold."""
    n = boxes.shape[0]
    scores = scores.float()
    if valid is not None:
        scores = torch.where(valid, scores, -torch.inf)
    order = torch.argsort(-scores, stable=True)
    iou = box_iou(boxes[order], boxes[order])
    is_valid = scores[order] > -torch.inf
    idx = torch.arange(n, device=boxes.device)
    sup = ((iou > iou_threshold) & (idx[None, :] < idx[:, None])).float()
    keep, prev = is_valid, torch.zeros_like(is_valid)
    for _ in range(n):
        if bool((keep == prev).all()):
            break
        keep, prev = is_valid & ~((sup @ keep.float()) > 0.0), keep
    out = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    out[order] = keep
    return out


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor, idxs: torch.Tensor,
                iou_threshold: float, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Boxes of different idxs never suppress each other (coordinate offsets)."""
    max_coord = boxes.abs().max() + 1.0
    offsets = idxs.float()[:, None] * (2.0 * max_coord)
    return nms(boxes + offsets, scores, iou_threshold, valid=valid)
