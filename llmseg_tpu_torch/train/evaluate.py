"""Validation, the counterpart of ``llmseg_tpu.train.evaluate``: the four
selection strategies (argmax similarity, IoP > tau, both, IoP > tau among
the top 5 by similarity), the mask compose and gIoU / cIoU.

Each image's predicted mask is the union of its selected proposals; it is
resized to the ground truth's shape when they differ, then both masks are
resized to 1024^2 (floor-index nearest), and the two-class intersection and
union are counted (``acc_iou[union == 0] += 1``, the no-object credit).
gIoU is the mean per-image foreground IoU, cIoU the foreground's summed
intersection over its summed union.

The compose and the counts run on the model's device (:func:`compose_counts`,
one image at a time on a side stream on the card); only the integer counts
come back, and the float math is done on the host in float64, as the numpy
path does, so both give the same bits.  The numpy path (:func:`compose_mask`,
:func:`_nearest_resize_2d`, :meth:`SegEvalAccumulator.add`) is the plain
version, which ``run_validation(..., plain=True)`` runs.

NAMING: the head called ``pred_iou`` regresses IoP (intersection over the
prediction), not IoU; every "IoP > tau" selection thresholds it.  The name
is the reference's, kept for parity.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from llmseg_tpu_torch.parallel import mesh as M
from llmseg_tpu_torch.utils.metrics import AverageMeter, Summary, intersection_and_union

EVAL_SIZE = 1024   # both masks are compared at 1024 x 1024


# ---------------------------------------------------------------------------
# mask compose, numpy (the plain version)
# ---------------------------------------------------------------------------


def _nearest_resize_2d(m: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """Floor-index nearest resize (not ``metrics._nearest_resize``'s
    half-pixel rule)."""
    H, W = hw
    h, w = m.shape
    rows = np.clip((np.arange(H) * h) // H, 0, h - 1)
    cols = np.clip((np.arange(W) * w) // W, 0, w - 1)
    return m[rows[:, None], cols[None, :]]


def compose_mask(segs_origin: np.ndarray, keep_ids: np.ndarray) -> np.ndarray:
    """Union of the selected proposals; (H, W, K) and ids -> (H, W) uint8."""
    if len(keep_ids) == 0:
        return np.zeros(segs_origin.shape[:2], np.uint8)
    return (segs_origin[:, :, keep_ids].sum(axis=-1) > 0).astype(np.uint8)


# ---------------------------------------------------------------------------
# mask compose and counts, torch (the path)
# ---------------------------------------------------------------------------


def _resize_index(n_out: int, n_in: int, device) -> torch.Tensor:
    return ((torch.arange(n_out, device=device) * n_in) // n_out).clamp_(0, n_in - 1)


def nearest_resize_2d(m: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """:func:`_nearest_resize_2d` on a tensor."""
    rows = _resize_index(hw[0], m.shape[0], m.device)
    cols = _resize_index(hw[1], m.shape[1], m.device)
    return m[rows[:, None], cols[None, :]]


def compose_counts(segs: torch.Tensor, keep: torch.Tensor, gt: torch.Tensor,
                   ignore_index: int = 255) -> torch.Tensor:
    """The union of the proposals ``keep`` of ``segs`` (H, W, K), resized to
    ``gt``'s shape if it differs, then both at 1024^2, and their two-class
    counts: (2, 2) int64, [intersection, union] of (background, foreground).
    ``gt`` takes numpy's cast to uint8 (floats truncate); its pixels equal
    to ``ignore_index`` count in neither class, as in
    ``metrics.intersection_and_union``."""
    if keep.numel():
        pred = (segs.index_select(2, keep) != 0).any(-1).to(torch.uint8)
    else:
        pred = torch.zeros(segs.shape[:2], dtype=torch.uint8, device=segs.device)
    if pred.shape != gt.shape:
        pred = nearest_resize_2d(pred, tuple(gt.shape))
    pred = nearest_resize_2d(pred, (EVAL_SIZE, EVAL_SIZE))
    gt = nearest_resize_2d(gt.to(torch.uint8), (EVAL_SIZE, EVAL_SIZE))
    counted = gt != ignore_index
    cls = torch.arange(2, device=segs.device)[:, None, None]
    p, t = pred == cls, gt == cls                     # (2, 1024, 1024) each
    inter = (p & t).sum((1, 2))
    area_out = (p & counted).sum((1, 2))
    area_tgt = t.sum((1, 2))
    return torch.stack([inter, area_out + area_tgt - inter])


# ---------------------------------------------------------------------------
# selection rules (numpy, on one row's (K,) scores)
# ---------------------------------------------------------------------------


def select_argmax_similarity(sim, iou, valid) -> np.ndarray:
    sim = np.where(valid, sim, -np.inf)
    return np.array([int(np.argmax(sim))])


def select_threshold(sim, iou, valid, threshold: float = 0.5) -> np.ndarray:
    """Every valid proposal whose IoP head is above the threshold."""
    return np.nonzero(valid & (iou > threshold))[0]


def select_iou_iop(sim, iou, valid, threshold: float = 0.5) -> np.ndarray:
    """The argmax of the similarity plus every proposal with IoP > tau."""
    ids = set(np.nonzero(valid & (iou > threshold))[0].tolist())
    ids.add(int(np.argmax(np.where(valid, sim, -np.inf))))
    return np.array(sorted(ids))


def select_threshold_from_top_iou(sim, iou, valid, threshold: float = 0.5,
                                  top_k: int = 5) -> np.ndarray:
    """The top K by similarity that also have IoP > tau."""
    simv = np.where(valid, sim, -np.inf)
    top = np.argsort(-simv)[:top_k]
    return np.array([i for i in top if valid[i] and iou[i] > threshold], np.int64)


SELECTORS = {
    "argmax": select_argmax_similarity,
    "threshold": select_threshold,
    "iou_iop": select_iou_iop,
    "top_iou": select_threshold_from_top_iou,
}


def select(strategy: str, sim, iou, valid, threshold: float = 0.5) -> np.ndarray:
    if strategy == "argmax":
        return SELECTORS[strategy](sim, iou, valid)
    return SELECTORS[strategy](sim, iou, valid, threshold)


# ---------------------------------------------------------------------------
# metric accumulation
# ---------------------------------------------------------------------------


class SegEvalAccumulator:
    """gIoU / cIoU counts; :meth:`result` sums them over ``group`` (the
    world when None; a mesh's data group, whose tp ranks count the same
    images once)."""

    def __init__(self, group=None):
        self.group = group
        self.intersection = AverageMeter("Intersec", ":6.3f", Summary.SUM)
        self.union = AverageMeter("Union", ":6.3f", Summary.SUM)
        self.acc_iou = AverageMeter("gIoU", ":6.3f", Summary.SUM)

    def add(self, pred: np.ndarray, gt: np.ndarray):
        """The numpy path: both masks resized to 1024^2 and counted."""
        pred = _nearest_resize_2d(pred.astype(np.uint8), (EVAL_SIZE, EVAL_SIZE))
        gt = _nearest_resize_2d(gt.astype(np.uint8), (EVAL_SIZE, EVAL_SIZE))
        inter, union, _ = intersection_and_union(pred.astype(np.int32), gt.astype(np.int32), 2)
        self.add_counts(inter, union)

    def add_counts(self, inter, union):
        """One image's (2,) intersection and union counts."""
        inter = np.asarray(inter, np.float64)
        union = np.asarray(union, np.float64)
        acc = inter / (union + 1e-8)
        acc[union == 0] += 1.0
        self.intersection.update(inter)
        self.union.update(union)
        self.acc_iou.update(acc, n=1)

    def result(self) -> Dict[str, float]:
        self.intersection.all_reduce(self.group)
        self.union.all_reduce(self.group)
        self.acc_iou.all_reduce(self.group)
        iou_class = self.intersection.sum / (self.union.sum + 1e-10)
        return {"giou": float(np.asarray(self.acc_iou.avg).reshape(-1)[1]),
                "ciou": float(np.asarray(iou_class).reshape(-1)[1])}


def _to_host(out: Dict) -> Tuple[Dict[str, np.ndarray], Optional[torch.cuda.Event]]:
    """Start copying a batch's scores to the host (pinned buffers, no
    wait) and return them with an event that marks the copy's end."""
    keys = ("pred_similarity", "pred_iou", "prop_valid")
    if not out["pred_iou"].is_cuda:
        return {k: out[k].float().numpy() if k != "prop_valid" else out[k].numpy()
                for k in keys}, None
    host = {}
    for k in keys:
        t = out[k] if k == "prop_valid" else out[k].float()
        host[k] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host[k].copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def run_validation(eval_step: Callable, model, batches: Iterable,
                   strategy: str = "threshold", threshold: float = 0.5,
                   visualize_dir: Optional[str] = None,
                   plain: bool = False) -> Dict[str, float]:
    """gIoU and cIoU over ``batches``, an iterable of (batch, extras) of any
    batch size; ``eval_step(model, batch)`` gives the scores
    (``train_step.eval_step``).  extras: ``segs_origin`` (per row, (H, W, K)
    numpy), ``masks_list`` (per row, a list whose first item is the (h, w)
    ground truth), ``image_paths`` and ``conversations`` (for
    ``visualize_dir``), and optionally ``row_valid``: False on a padded
    final batch's filler rows, which are skipped.

    One-deep pipeline: batch i+1's forward is enqueued before batch i's
    scores are read.  The scores come to the host through pinned buffers
    and an event, so reading them waits for batch i's forward alone; the
    compose and the counts run on a side stream of the card, beside the
    next forward.  ``plain`` composes and counts with numpy on the host
    instead (the JAX loop's way).  On a mesh (``model.mesh``) the counts
    are summed over its data group."""
    acc = SegEvalAccumulator(M.data_group(model))
    counts = []      # per image, (2, 2) on the device, read at the end
    side = None      # the card's side stream, made at the first batch on it

    def _stream():
        return contextlib.nullcontext() if side is None else torch.cuda.stream(side)

    def _finish(host, done, extras):
        nonlocal side
        device = torch.device("cpu")
        if done is not None:
            done.synchronize()
            device = torch.device("cuda")
            side = side or torch.cuda.Stream()
        sim_b, iou_b, valid_b = (np.asarray(host[k]) for k in
                                 ("pred_similarity", "pred_iou", "prop_valid"))
        row_valid = extras.get("row_valid")
        for i in range(sim_b.shape[0]):
            if row_valid is not None and not row_valid[i]:
                continue
            sim, iou, valid = sim_b[i], iou_b[i], valid_b[i]
            keep = select(strategy, sim, iou, valid, threshold)
            segs_origin = extras["segs_origin"][i]
            gt = extras["masks_list"][i][0]
            if plain or visualize_dir:
                pred = compose_mask(segs_origin, keep)
                if pred.shape != gt.shape:
                    pred = _nearest_resize_2d(pred, gt.shape)
            if plain:
                acc.add(pred, gt)
            else:
                with _stream():
                    counts.append(compose_counts(
                        torch.as_tensor(segs_origin).to(device),
                        torch.as_tensor(np.asarray(keep, np.int64)).to(device),
                        torch.as_tensor(np.asarray(gt)).to(device)))
            if visualize_dir:
                _dump_visualization(visualize_dir, extras, pred, gt, sim, iou, index=i)

    pending = None
    for batch, extras in batches:
        host, done = _to_host(eval_step(model, batch))
        if pending is not None:
            _finish(*pending)
        pending = (host, done, extras)
    if pending is not None:
        _finish(*pending)
    if counts:
        with _stream():
            all_counts = torch.stack(counts).cpu().numpy()
        for c in all_counts:
            acc.add_counts(c[0], c[1])
    return acc.result()


def _dump_visualization(out_dir: str, extras: Dict, pred: np.ndarray, gt: np.ndarray,
                        sim: np.ndarray, iou: np.ndarray, index: int = 0):
    """The image, the prediction and the ground truth as overlays, and a text
    file with the conversation and the scores."""
    import os

    import cv2

    os.makedirs(out_dir, exist_ok=True)
    image_path = extras["image_paths"][index]
    if image_path is None or not os.path.exists(image_path):
        return
    name = os.path.splitext(os.path.basename(image_path))[0]
    image = cv2.imread(image_path)
    if image is None:
        return
    ph, pw = image.shape[:2]
    pred_r = _nearest_resize_2d(pred, (ph, pw))
    gt_r = _nearest_resize_2d(gt.astype(np.uint8), (ph, pw))
    cv2.imwrite(os.path.join(out_dir, f"{name}.png"), image)
    for tag, m in (("pred", pred_r), ("gt", gt_r)):
        overlay = image.copy()
        overlay[m > 0] = (overlay[m > 0] * 0.5 + np.array([0, 0, 255]) * 0.5).astype(np.uint8)
        cv2.imwrite(os.path.join(out_dir, f"{name}_{tag}.png"), overlay)
    with open(os.path.join(out_dir, f"{name}.txt"), "w") as f:
        convs = extras.get("conversations") or [[""]] * (index + 1)
        f.write(str(convs[index]) + "\n")
        f.write("pred_iou: " + " ".join(f"{v:.3f}" for v in iou) + "\n")
        f.write("similarity: " + " ".join(f"{v:.3f}" for v in sim) + "\n")
