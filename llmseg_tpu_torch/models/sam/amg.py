"""Everything-mode automatic mask generation (AMG), the counterpart of
``llmseg_tpu.models.sam.amg``.

``amg_select`` decodes every grid point against one image embedding in
chunks of ``points_per_batch`` (kernel G on the card), casts the low-res
logits to bf16, filters by predicted IoU and stability, takes inclusive
boxes, runs NMS and keeps the top ``max_masks`` by predicted IoU, all on the
device.  ``AutomaticMaskGenerator`` drives it: ``submit`` (encode + select),
``prefetch`` (survivor metadata, then the upscale of the survivors: run
boundaries computed on the device, or bit-packed bitmaps when small regions
are cleaned), ``finish`` (RLE and the annotation schema on the host).  The
crop cascade (``crop_n_layers > 0``) is not ported: it resizes crops with
PIL.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from llmseg_tpu_torch.config import AMGConfig, SamConfig
from llmseg_tpu_torch.device import require
from llmseg_tpu_torch.models.sam import sam as sam_lib
from llmseg_tpu_torch.ops import amg_utils, device_rle, nms, rle

# per-column run-start budget of the device RLE; blobby SAM masks have 1-2
MAX_RUNS_PER_COL = 8


def _candidate_filters(low_masks, iou_pred, amg: AMGConfig, cfg: SamConfig,
                       valid_hw: Tuple[int, int]):
    """IoU and stability filters on low-res logits (N, S, S) outside the
    padded area.  Returns (keep, stability, masked logits)."""
    S = low_masks.shape[-1]
    row = torch.arange(S, device=low_masks.device)
    region = ((row < valid_hw[0])[:, None] & (row < valid_hw[1])[None, :])[None]
    neg = cfg.mask_threshold - 2.0 * amg.stability_score_offset - 1.0
    masked = torch.where(region, low_masks, torch.tensor(neg, dtype=low_masks.dtype,
                                                         device=low_masks.device))
    keep = iou_pred > amg.pred_iou_thresh
    stability = amg_utils.calculate_stability_score(masked, cfg.mask_threshold,
                                                    amg.stability_score_offset)
    keep &= stability >= amg.stability_score_thresh
    return keep, stability, masked


@torch.no_grad()
def amg_select(model, amg: AMGConfig, image_embedding: torch.Tensor, points: torch.Tensor,
               valid_hw: Tuple[int, int]) -> Dict:
    """Grid prompts -> filtered, NMS'd top-K candidates.  image_embedding
    (1, G, G, C); points (P, 2) input-frame pixels; valid_hw the image's
    extent.  Returns K = max_masks rows: masks_low (K, S, S) bf16, iou,
    stability, boxes (K, 4) input-frame xyxy, points (K, 2), valid (K,)."""
    cfg = model.cfg
    P = points.shape[0]
    B = amg.points_per_batch
    n_chunks = -(-P // B)
    S4 = cfg.prompt.image_embedding_size * 4
    pts = torch.nn.functional.pad(points, (0, 0, 0, n_chunks * B - P)).reshape(n_chunks, B, 1, 2)
    labels = torch.ones(B, 1, dtype=torch.int32, device=points.device)
    masks, ious = [], []
    cache = {}    # every chunk shares the image: kernel G's sequence is recorded once
    for c in range(n_chunks):
        m, i = sam_lib.decode_masks(model, image_embedding, points=pts[c], labels=labels,
                                    multimask_output=True, cache=cache)
        masks.append(m.to(torch.bfloat16))   # the filters see bf16 logits
        ious.append(i)
    masks = torch.stack(masks).reshape(-1, S4, S4)
    iou_pred = torch.stack(ious).reshape(-1)
    M = masks.shape[0]
    point_per_mask = pts.reshape(-1, 2).repeat_interleave(3, 0)
    real = torch.arange(M, device=masks.device) // 3 < P
    img = cfg.encoder.img_size
    lowres_hw = (max(valid_hw[0] * S4 // img, 1), max(valid_hw[1] * S4 // img, 1))
    keep, stability, masked = _candidate_filters(masks, iou_pred, amg, cfg, lowres_hw)
    keep &= real
    binary = masked > cfg.mask_threshold
    boxes = amg_utils.batched_mask_to_box(binary) * (img / S4)
    keep &= binary.any(-1).any(-1)
    keep_nms = nms.nms(boxes, iou_pred, amg.box_nms_thresh, valid=keep)
    score = torch.where(keep_nms, iou_pred, -torch.inf)
    top = torch.argsort(-score, stable=True)[:amg.max_masks]
    return {"masks_low": masks[top], "iou": iou_pred[top], "stability": stability[top],
            "boxes": boxes[top], "points": point_per_mask[top], "valid": keep_nms[top]}


@torch.no_grad()
def upscale_binary(masks_low: torch.Tensor, out_hw: Tuple[int, int], threshold: float = 0.0,
                   bucket: Optional[int] = None) -> torch.Tensor:
    """(K, S, S) logits -> (K, H, W // 8) bit-packed (MSB first) masks at
    the input-frame resolution."""
    if bucket is not None:
        masks_low = masks_low[:bucket]
    K = masks_low.shape[0]
    bits = (amg_utils.resize_bilinear(masks_low, out_hw) > threshold).to(torch.uint8)
    bits = bits.reshape(K, out_hw[0], out_hw[1] // 8, 8)
    weights = 2 ** torch.arange(7, -1, -1, device=bits.device, dtype=torch.int32)
    return (bits.int() * weights).sum(-1).to(torch.uint8)


class AutomaticMaskGenerator:
    """The reference generator's ``generate()`` contract, on the model's
    device: ``device`` (the card by default) must be the model's."""

    def __init__(self, model, cfg: Optional[SamConfig] = None,
                 amg: Optional[AMGConfig] = None, *, device="cuda"):
        self.device = require(device)
        if next(model.parameters()).device.type != self.device.type:
            raise ValueError(f"the model is on {next(model.parameters()).device}, "
                             f"not {self.device}")
        self.model = model
        self.cfg = cfg or model.cfg
        self.amg = amg or AMGConfig()
        self._grid = amg_utils.build_point_grid(self.amg.points_per_side)

    def generate(self, image: np.ndarray) -> List[Dict]:
        """image (H, W, 3) uint8 with its longest side <= the SAM input size
        -> reference-schema annotations sorted by area, descending."""
        return self.finish(self.submit(image))

    @torch.inference_mode()
    def submit(self, image: np.ndarray) -> Dict:
        """Enqueue the device work (encode + select) without waiting for it."""
        h, w = image.shape[:2]
        s_in = self.cfg.encoder.img_size
        if max(h, w) > s_in:
            raise ValueError(f"image {h}x{w} exceeds the SAM input {s_in}; "
                             "resize its longest side first")
        if self.amg.crop_n_layers > 0:
            raise NotImplementedError("the AMG crop cascade is not ported")
        padded = np.zeros((s_in, s_in, 3), image.dtype)
        padded[:h, :w] = image
        # normalise, then zero outside the image, as the reference pads
        region = torch.zeros(1, s_in, s_in, 1, device=self.device)
        region[:, :h, :w] = 1.0
        x = torch.from_numpy(padded)[None].to(self.device)
        emb = sam_lib.encode_image(self.model, sam_lib.preprocess(x, self.cfg) * region)
        points = torch.tensor(self._grid * np.array([w, h]), dtype=torch.float32,
                              device=self.device)
        return {"out": amg_select(self.model, self.amg, emb, points, (h, w)), "hw": (h, w)}

    def _bucket(self, n: int) -> int:
        return min(max(8, 1 << (n - 1).bit_length()), self.amg.max_masks)

    @torch.inference_mode()
    def prefetch(self, handle: Dict) -> Dict:
        """Pull the survivor metadata and enqueue the survivors' upscale
        (run boundaries on the device, or bit-packed bitmaps when small
        regions are cleaned).  Idempotent; ``finish`` calls it."""
        if "n" in handle:
            return handle
        out = handle["out"]
        small = {k: out[k].float().cpu().numpy() for k in ("iou", "stability", "boxes", "points")}
        small["valid"] = out["valid"].cpu().numpy()
        n = int(small["valid"].sum())
        handle["n"], handle["small"] = n, small
        if not n:
            return handle
        s_in = self.cfg.encoder.img_size
        if self.amg.min_mask_region_area == 0:
            handle["rle_dev"] = device_rle.upscale_rle(
                out["masks_low"], handle["hw"], (s_in, s_in), self.cfg.mask_threshold,
                bucket=self._bucket(n), max_per_col=MAX_RUNS_PER_COL)
        else:
            handle["packed_dev"] = upscale_binary(out["masks_low"], (s_in, s_in),
                                                  self.cfg.mask_threshold, bucket=self._bucket(n))
        return handle

    def finish(self, handle: Dict) -> List[Dict]:
        """Download a submit()'s survivors and assemble the annotations."""
        h, w = handle["hw"]
        self.prefetch(handle)
        s_in = self.cfg.encoder.img_size
        n, small = handle["n"], handle["small"]
        if n == 0:
            return []
        iou, stability, pts = small["iou"][:n], small["stability"][:n], small["points"][:n]
        if "rle_dev" in handle:
            payload16, meta32 = (t.cpu().numpy() for t in handle["rle_dev"])
            return self._assemble_rle(payload16, meta32, handle, n, iou, stability, pts, h, w)
        packed = handle["packed_dev"].cpu().numpy()
        masks = np.unpackbits(packed[:n], axis=-1, count=s_in).reshape(n, s_in, s_in)
        masks = masks[:, :h, :w].astype(bool)
        return self._assemble(masks, iou, stability, pts, [(0, 0, w, h)] * n, h, w)

    def _assemble_rle(self, payload16, meta32, handle, n: int, iou, stability, pts,
                      h: int, w: int) -> List[Dict]:
        """Annotations from the device run boundaries; masks whose columns
        overflowed take the bit-packed path, in one batch."""
        s_in = self.cfg.encoder.img_size
        decoded = device_rle.annotations_from_rle_payload(payload16, meta32, n, h, w, s_in,
                                                          MAX_RUNS_PER_COL)
        packed = None
        if any(d is None for d in decoded):
            with torch.inference_mode():
                packed = upscale_binary(handle["out"]["masks_low"], (s_in, s_in),
                                        self.cfg.mask_threshold,
                                        bucket=self._bucket(n)).cpu().numpy()
        anns = []
        for i, d in enumerate(decoded):
            r, area_i, bbox = rle.encode_packed(packed[i], h, w) if d is None else d
            if area_i == 0:
                continue
            anns.append({"segmentation": r, "area": int(area_i),
                         "bbox": [float(v) for v in bbox],
                         "predicted_iou": float(iou[i]),
                         "point_coords": [[float(pts[i][0]), float(pts[i][1])]],
                         "stability_score": float(stability[i]),
                         "crop_box": [0, 0, w, h]})
        anns.sort(key=lambda a: a["area"], reverse=True)
        return anns

    def _assemble(self, masks, iou, stability, pts, crop_boxes, h: int, w: int) -> List[Dict]:
        """Small-region cleanup, the re-dedup NMS, and the annotations."""
        if len(masks) == 0:
            return []
        if self.amg.min_mask_region_area > 0:
            # remove holes and islands, then NMS with score 1 for unchanged
            # masks and 0 for changed ones, so a cleaned duplicate dies
            cleaned, unchanged = [], []
            for m in masks:
                mm, ch_h = amg_utils.remove_small_regions(
                    m.astype(bool), self.amg.min_mask_region_area, "holes")
                mm, ch_i = amg_utils.remove_small_regions(
                    mm, self.amg.min_mask_region_area, "islands")
                cleaned.append(mm)
                unchanged.append(not (ch_h or ch_i))
            masks = np.stack(cleaned)
            keep = np.sort(amg_utils.nms_host(
                _mask_boxes_np(masks), np.asarray(unchanged, np.float32),
                max(self.amg.box_nms_thresh, self.amg.crop_nms_thresh)))
            masks, iou, stability, pts = masks[keep], iou[keep], stability[keep], pts[keep]
            crop_boxes = [crop_boxes[i] for i in keep]
        anns = []
        for i in range(len(masks)):
            r, area, bbox = rle.encode_stats(masks[i].astype(np.uint8))
            if area == 0:
                continue
            cb = crop_boxes[i]
            anns.append({"segmentation": r, "area": area, "bbox": bbox,
                         "predicted_iou": float(iou[i]),
                         "point_coords": [[float(pts[i][0]), float(pts[i][1])]],
                         "stability_score": float(stability[i]),
                         "crop_box": [int(cb[0]), int(cb[1]),
                                      int(cb[2] - cb[0]), int(cb[3] - cb[1])]})
        anns.sort(key=lambda a: a["area"], reverse=True)
        return anns


def _mask_boxes_np(masks: np.ndarray) -> np.ndarray:
    """(N, H, W) bool -> inclusive-edge xyxy boxes, zeros for empty masks."""
    out = np.zeros((len(masks), 4), np.float64)
    for i, m in enumerate(masks):
        ys, xs = np.nonzero(m)
        if len(ys):
            out[i] = [xs.min(), ys.min(), xs.max(), ys.max()]
    return out
