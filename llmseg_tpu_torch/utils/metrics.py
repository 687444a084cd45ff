"""Metrics and meters, the counterpart of ``llmseg_tpu.utils.metrics``.

The per-proposal IoU/IoP labels are the JAX module's numpy path (the port
has no native library), vectorised over the proposals; the meters are
copies.  ``AverageMeter.all_reduce`` is a no-op: the port runs in one
process.
"""

from __future__ import annotations

from enum import Enum
from typing import Tuple

import numpy as np


# ---------------------------------------------------------------------------
# IoU / IoP labels (host, numpy)
# ---------------------------------------------------------------------------


def _nearest_resize(gt: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """Order-0 (nearest) resize as ``skimage.transform.resize(order=0,
    anti_aliasing=False)``: sample at (out_idx + 0.5) * in / out - 0.5,
    rounded half to even."""
    H, W = hw
    h, w = gt.shape
    rows = np.clip(np.rint((np.arange(H) + 0.5) * h / H - 0.5).astype(int), 0, h - 1)
    cols = np.clip(np.rint((np.arange(W) + 0.5) * w / W - 0.5).astype(int), 0, w - 1)
    return gt[rows[:, None], cols[None, :]]


def compute_iou(seg: np.ndarray, gt: np.ndarray) -> float:
    inter = np.logical_and(seg, gt).sum()
    union = np.logical_or(seg, gt).sum()
    return float(inter / union) if union else 0.0


def compute_iop(seg: np.ndarray, gt: np.ndarray) -> float:
    inter = np.logical_and(seg, gt).sum()
    area = np.asarray(seg, bool).sum()
    return float(inter / area) if area else 0.0


def compute_all_iou_iop(segs: np.ndarray, gt: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """segs: (H, W, K) binary proposals; gt: (H', W') binary, resized to
    (H, W) nearest.  Returns (iou (K,), iop (K,)) float32 in one pass."""
    H, W, K = segs.shape
    gtb = _nearest_resize(np.asarray(gt, np.uint8), (H, W)).astype(bool)
    p = np.ascontiguousarray(segs.transpose(2, 0, 1), np.uint8).astype(bool)
    inter = np.logical_and(p, gtb).sum(axis=(1, 2))
    parea = p.sum(axis=(1, 2))
    union = parea + gtb.sum() - inter
    iou = np.where(union > 0, inter / np.maximum(union, 1), 0.0)
    iop = np.where(parea > 0, inter / np.maximum(parea, 1), 0.0)
    return iou.astype(np.float32), iop.astype(np.float32)


def compute_all_iou(segs: np.ndarray, gt: np.ndarray) -> np.ndarray:
    return compute_all_iou_iop(segs, gt)[0]


def compute_all_iop(segs: np.ndarray, gt: np.ndarray) -> np.ndarray:
    return compute_all_iou_iop(segs, gt)[1]


def intersection_and_union(output: np.ndarray, target: np.ndarray, K: int,
                           ignore_index: int = 255):
    """Histogram class intersection and union.  Returns (intersection,
    union, target area), each (K,) float64."""
    output = np.asarray(output).reshape(-1).copy()
    target = np.asarray(target).reshape(-1)
    output[target == ignore_index] = ignore_index
    inter = output[output == target]
    bins = np.arange(K + 1) - 0.5
    area_inter = np.histogram(inter, bins=bins)[0]
    area_out = np.histogram(output, bins=bins)[0]
    area_tgt = np.histogram(target, bins=bins)[0]
    return (area_inter.astype(np.float64),
            (area_out + area_tgt - area_inter).astype(np.float64),
            area_tgt.astype(np.float64))


# ---------------------------------------------------------------------------
# Meters
# ---------------------------------------------------------------------------


class Summary(Enum):
    NONE = 0
    AVERAGE = 1
    SUM = 2
    COUNT = 3


class AverageMeter:
    def __init__(self, name: str, fmt: str = ":f",
                 summary_type: Summary = Summary.AVERAGE):
        self.name, self.fmt, self.summary_type = name, fmt, summary_type
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0.0
        self.avg = 0.0

    def update(self, val, n: int = 1):
        """val may be a scalar or an array."""
        val = np.asarray(val, np.float64)
        self.val = val if val.ndim else float(val)
        self.sum = self.sum + val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1e-12)

    def all_reduce(self):
        """The cross-process sum; one process holds every count already."""

    def __str__(self):
        val = float(np.mean(self.val))
        avg = float(np.mean(self.avg))
        fmtstr = "{name} {val" + self.fmt + "} ({avg" + self.fmt + "})"
        return fmtstr.format(name=self.name, val=val, avg=avg)

    def summary(self):
        if self.summary_type is Summary.NONE:
            return ""
        if self.summary_type is Summary.AVERAGE:
            return f"{self.name} {float(np.mean(self.avg)):.3f}"
        if self.summary_type is Summary.SUM:
            return f"{self.name} {float(np.mean(self.sum)):.3f}"
        return f"{self.name} {self.count:.1f}"


class ProgressMeter:
    def __init__(self, num_batches: int, meters, prefix: str = ""):
        fmt = "{:" + str(len(str(num_batches))) + "d}"
        self.batch_fmtstr = "[" + fmt + "/" + fmt.format(num_batches) + "]"
        self.meters = meters
        self.prefix = prefix

    def display(self, batch: int):
        entries = [self.prefix + self.batch_fmtstr.format(batch)]
        entries += [str(m) for m in self.meters]
        print("\t".join(entries), flush=True)

    def display_summary(self):
        entries = [" *"] + [m.summary() for m in self.meters]
        print(" ".join(entries), flush=True)
