"""Box NMS, the counterpart of ``llmseg_tpu.ops.nms``: the exact greedy
result, on the boxes' device.  Sorts are stable, so ties keep index order
as in the JAX package.

:func:`nms` takes the fixpoint iteration over the IoU matrix on the CPU
(:func:`nms_fixpoint`, the JAX package's form) and, on the card, the
greedy sweep over a suppression bitmask (``csrc/greedy_nms.cu``), which
never waits for the host.  Both give the greedy result bit for bit;
:func:`nms_bitmask_plain` is the sweep's plain version."""

from __future__ import annotations

from typing import Optional

import torch

from llmseg_tpu_torch.ops.kernels import Kernel

GREEDY_NMS = Kernel("greedy_nms")   # csrc/greedy_nms.cu: the bitmask and the sweep, one call
WORD = 64                           # suppression bits a word


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


def _sorted(scores: torch.Tensor, valid: Optional[torch.Tensor]):
    """float32 scores, -inf where invalid, and their stable descending order."""
    scores = scores.float()
    if valid is not None:
        scores = torch.where(valid, scores, -torch.inf)
    return scores, torch.argsort(-scores, stable=True)


def nms_fixpoint(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
                 valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The greedy result as the unique fixpoint of keep = valid & no kept
    higher-scoring box overlaps it, iterated from keep = valid; each step
    tests for the end on the host."""
    n = boxes.shape[0]
    scores, order = _sorted(scores, valid)
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


def _pack(bits: torch.Tensor) -> torch.Tensor:
    """(R, N) bool -> (R, ceil(N / 64)) int64 words, bit j of word c from
    column 64 c + j."""
    r, n = bits.shape
    words = -(-n // WORD)
    bits = torch.nn.functional.pad(bits, (0, words * WORD - n)).reshape(r, words, WORD)
    shifts = torch.arange(WORD, device=bits.device, dtype=torch.int64)
    return (bits.long() << shifts).sum(-1)   # disjoint bits: the sum is the OR


def suppression_words(boxes_sorted: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """The kernel's bitmask: (N, 4) boxes in score order -> (N, ceil(N / 64))
    int64 words, bit j of word c of row i set where the later box 64 c + j
    overlaps box i above the threshold (the fixpoint's comparisons, read by
    column: ``box_iou`` is symmetric to the bit)."""
    n = boxes_sorted.shape[0]
    idx = torch.arange(n, device=boxes_sorted.device)
    iou = box_iou(boxes_sorted, boxes_sorted)
    return _pack((iou > iou_threshold).T & (idx[None, :] > idx[:, None]))


def nms_bitmask_plain(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``csrc/greedy_nms.cu``'s function: the suppression bitmask, then the
    sweep in score order, a box kept unless its removed bit is set (invalid
    boxes set theirs at the start), a kept box ORing its row into the
    removed bits."""
    n = boxes.shape[0]
    scores, order = _sorted(scores, valid)
    mask = suppression_words(boxes.float()[order], iou_threshold)
    removed = _pack(~(scores[order] > -torch.inf)[None])[0]
    keep = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    for i in range(n):
        if not bool((removed[i // WORD] >> (i % WORD)) & 1):
            keep[i] = True
            removed |= mask[i]
    out = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    out[order] = keep
    return out


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
               valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The greedy NMS kernel on CUDA tensors: the stable sort by score, then
    one launch of ``csrc/greedy_nms.cu`` on the current stream.  Nothing
    waits for the host."""
    n = boxes.shape[0]
    if boxes.shape != (n, 4) or scores.shape != (n,) or (
            valid is not None and valid.shape != (n,)):
        raise ValueError(f"expected boxes (N, 4), scores and valid (N,); got "
                         f"{tuple(boxes.shape)}, {tuple(scores.shape)}")
    if n == 0:
        return torch.zeros(0, dtype=torch.bool, device=boxes.device)
    scores, order = _sorted(scores, valid)
    boxes = boxes.float().contiguous()
    mask = torch.empty(n, -(-n // WORD), dtype=torch.int64, device=boxes.device)
    keep = torch.empty(n, dtype=torch.bool, device=boxes.device)
    GREEDY_NMS.launch(boxes.data_ptr(), scores.contiguous().data_ptr(), order.data_ptr(),
                      mask.data_ptr(), keep.data_ptr(), n, float(iou_threshold))
    return keep


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy NMS: keep (N,) bool in the original order.  Invalid entries are
    never kept and never suppress; a box is kept iff no higher-scoring kept
    box overlaps it above the threshold.  The kernel on the card, the
    fixpoint on the CPU."""
    if boxes.is_cuda:
        return greedy_nms(boxes, scores, iou_threshold, valid)
    return nms_fixpoint(boxes, scores, iou_threshold, valid)


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor, idxs: torch.Tensor,
                iou_threshold: float, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Boxes of different idxs never suppress each other (coordinate offsets)."""
    max_coord = boxes.abs().max() + 1.0
    offsets = idxs.float()[:, None] * (2.0 * max_coord)
    return nms(boxes + offsets, scores, iou_threshold, valid=valid)
