"""AMG primitives, the counterpart of ``llmseg_tpu.ops.amg_utils``: point
grids and crop boxes (numpy), the stability score, mask boxes and the
crop-edge test (torch, on the masks' device), the host bilinear resize, the
host greedy NMS and the small-region cleanup (scipy), and the uncrop of
boxes and points.  Also
:func:`resize_bilinear`, the port of ``jax.image.resize(..., "bilinear")``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Point grids and crop boxes (host)
# ---------------------------------------------------------------------------


def build_point_grid(n_per_side: int) -> np.ndarray:
    """(n^2, 2) normalised xy grid with a half-cell offset, x fastest."""
    offset = 1.0 / (2 * n_per_side)
    pts = np.linspace(offset, 1.0 - offset, n_per_side)
    gx, gy = np.meshgrid(pts, pts)
    return np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1)


def build_all_layer_point_grids(n_per_side: int, n_layers: int,
                                scale_per_layer: int) -> List[np.ndarray]:
    return [build_point_grid(int(n_per_side / (scale_per_layer ** i)))
            for i in range(n_layers + 1)]


def generate_crop_boxes(im_size: Tuple[int, int], n_layers: int, overlap_ratio: float):
    """Crop boxes (xyxy) of every layer and their layer indexes."""
    crop_boxes, layer_idxs = [], []
    im_h, im_w = im_size
    short_side = min(im_h, im_w)
    crop_boxes.append([0, 0, im_w, im_h])
    layer_idxs.append(0)

    def crop_len(orig_len, n_crops, overlap):
        return int(np.ceil((overlap * (n_crops - 1) + orig_len) / n_crops))

    for i_layer in range(n_layers):
        n_crops_per_side = 2 ** (i_layer + 1)
        overlap = int(overlap_ratio * short_side * (2 / n_crops_per_side))
        crop_w = crop_len(im_w, n_crops_per_side, overlap)
        crop_h = crop_len(im_h, n_crops_per_side, overlap)
        crop_box_x0 = [int((crop_w - overlap) * i) for i in range(n_crops_per_side)]
        crop_box_y0 = [int((crop_h - overlap) * i) for i in range(n_crops_per_side)]
        for x0 in crop_box_x0:
            for y0 in crop_box_y0:
                crop_boxes.append([x0, y0, min(x0 + crop_w, im_w), min(y0 + crop_h, im_h)])
                layer_idxs.append(i_layer + 1)
    return crop_boxes, layer_idxs


# ---------------------------------------------------------------------------
# Device-side filters
# ---------------------------------------------------------------------------


def calculate_stability_score(mask_logits: torch.Tensor, mask_threshold: float,
                              threshold_offset: float) -> torch.Tensor:
    """IoU of the high- and low-threshold binarisations, (..., H, W) -> (...)
    float32; the thresholds are compared in the logits' dtype."""
    hi = (mask_logits > (mask_threshold + threshold_offset)).float().sum((-2, -1))
    lo = (mask_logits > (mask_threshold - threshold_offset)).float().sum((-2, -1))
    return torch.where(lo > 0, hi / lo, 0.0)


def batched_mask_to_box(masks: torch.Tensor) -> torch.Tensor:
    """Binary masks (..., H, W) -> float32 xyxy boxes with INCLUSIVE right /
    bottom edges (the max pixel index); zeros for empty masks."""
    H, W = masks.shape[-2:]
    m = masks.bool()
    any_row, any_col = m.any(-1), m.any(-2)
    rows = torch.arange(H, device=m.device)
    cols = torch.arange(W, device=m.device)
    top = torch.where(any_row, rows, H).amin(-1)
    bottom = torch.where(any_row, rows, -1).amax(-1)
    left = torch.where(any_col, cols, W).amin(-1)
    right = torch.where(any_col, cols, -1).amax(-1)
    box = torch.stack([left, top, right, bottom], -1)
    return torch.where(any_row.any(-1)[..., None], box, 0).float()


def is_box_near_crop_edge(boxes: torch.Tensor, crop_box, orig_box,
                          atol: float = 20.0) -> torch.Tensor:
    """True where a box touches the crop edge but not the image edge."""
    crop = torch.as_tensor(crop_box, dtype=torch.float32, device=boxes.device)
    orig = torch.as_tensor(orig_box, dtype=torch.float32, device=boxes.device)
    b = uncrop_boxes_xyxy(boxes.float(), crop)
    near_crop = (b - crop[None]).abs() <= atol
    near_image = (b - orig[None]).abs() <= atol
    return (near_crop & ~near_image).any(-1)


def uncrop_boxes_xyxy(boxes: torch.Tensor, crop_box) -> torch.Tensor:
    """xyxy boxes (..., 4) in a crop's frame -> the full image's (offset by
    the crop's top-left corner), in the boxes' dtype."""
    return boxes + torch.as_tensor(crop_box[:2], dtype=boxes.dtype, device=boxes.device).repeat(2)


def uncrop_points(points: torch.Tensor, crop_box) -> torch.Tensor:
    """xy points (..., 2) in a crop's frame -> the full image's."""
    return points + torch.as_tensor(crop_box[:2], dtype=points.dtype, device=points.device)


# ---------------------------------------------------------------------------
# Resizes
# ---------------------------------------------------------------------------


def _weight_mat(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) weights of jax.image's scale_and_translate with the
    triangle kernel, antialiased (the kernel widened by 1/scale) when it
    shrinks; float32 as JAX computes them."""
    f32 = torch.float32
    inv_scale = torch.tensor(1.0, dtype=f32) / torch.tensor(n_out / n_in, dtype=f32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = (torch.arange(n_out, dtype=f32) + 0.5) * inv_scale - 0.0 * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(n_in, dtype=f32)[:, None]).abs() / kernel_scale
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0).to(device)


def resize_bilinear(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(x, ..., "bilinear")`` over the last two axes, in
    float32: half-pixel centres, antialiased when it shrinks; the rows are
    resized first, then the columns, as JAX does."""
    x = x.float()
    H, W = x.shape[-2:]
    if H != hw[0]:
        x = torch.einsum("...hw,ho->...ow", x, _weight_mat(H, hw[0], x.device))
    if W != hw[1]:
        x = torch.einsum("...hw,wo->...ho", x, _weight_mat(W, hw[1], x.device))
    return x


def bilinear_resize_np(a: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Half-pixel-centre bilinear resize on the host, (..., H, W) -> float32."""
    H, W = a.shape[-2:]
    oh, ow = out_hw
    a = a.astype(np.float32)
    ys = (np.arange(oh) + 0.5) * (H / oh) - 0.5
    xs = (np.arange(ow) + 0.5) * (W / ow) - 0.5
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    wy = (ys - y0).astype(np.float32)[:, None]
    wx = (xs - x0).astype(np.float32)[None, :]
    y0c, y1c = np.clip(y0, 0, H - 1), np.clip(y0 + 1, 0, H - 1)
    x0c, x1c = np.clip(x0, 0, W - 1), np.clip(x0 + 1, 0, W - 1)
    ia = a[..., y0c[:, None], x0c[None, :]]
    ib = a[..., y0c[:, None], x1c[None, :]]
    ic = a[..., y1c[:, None], x0c[None, :]]
    id_ = a[..., y1c[:, None], x1c[None, :]]
    return (ia * (1 - wy) * (1 - wx) + ib * (1 - wy) * wx
            + ic * wy * (1 - wx) + id_ * wy * wx)


# ---------------------------------------------------------------------------
# Host NMS and small-region cleanup
# ---------------------------------------------------------------------------


def nms_host(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float) -> np.ndarray:
    """Greedy NMS with torchvision semantics (IoU from the xyxy extents as
    given).  Returns kept indices in descending-score order."""
    if len(boxes) == 0:
        return np.zeros((0,), np.int64)
    boxes = boxes.astype(np.float64)
    order = np.argsort(-scores, kind="stable")
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    keep = []
    suppressed = np.zeros(len(boxes), bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        x0 = np.maximum(boxes[i, 0], boxes[:, 0])
        y0 = np.maximum(boxes[i, 1], boxes[:, 1])
        x1 = np.minimum(boxes[i, 2], boxes[:, 2])
        y1 = np.minimum(boxes[i, 3], boxes[:, 3])
        inter = np.maximum(x1 - x0, 0) * np.maximum(y1 - y0, 0)
        iou = inter / np.maximum(areas[i] + areas - inter, 1e-12)
        suppressed |= iou > iou_threshold
    return np.asarray(keep, np.int64)


def remove_small_regions(mask: np.ndarray, area_thresh: float,
                         mode: str) -> Tuple[np.ndarray, bool]:
    """Fill holes ('holes') or drop islands ('islands') smaller than
    area_thresh, 8-connected.  Returns (mask, modified)."""
    if mode not in ("holes", "islands"):
        raise ValueError(mode)
    from scipy import ndimage

    correct_holes = mode == "holes"
    working = (mask ^ correct_holes).astype(np.uint8)
    labels, n = ndimage.label(working, structure=np.ones((3, 3), np.int32))
    if n == 0:
        return mask, False
    sizes = ndimage.sum_labels(np.ones_like(working), labels, index=np.arange(1, n + 1))
    small = [i + 1 for i, s in enumerate(sizes) if s < area_thresh]
    if not small:
        return mask, False
    fill = np.isin(labels, small)
    if correct_holes:
        out = mask | fill
    else:
        out = mask & ~fill
        if not out.any():   # keep the largest island if everything was small
            out = labels == int(np.argmax(sizes)) + 1
    return out, True
