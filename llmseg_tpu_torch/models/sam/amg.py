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
crop cascade (``crop_n_layers > 0``) runs the full frame and every crop
(resized to the SAM input with ``data.image_ops.resize_longest_side``)
through the same ``amg_select``, drops candidates on a crop's inner edge,
upscales each crop's survivors to the crop's extent on the device and
dedups across crops on the host, smaller crops first.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from llmseg_tpu_torch.config import AMGConfig, SamConfig
from llmseg_tpu_torch.data import image_ops
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
               valid_hw: Tuple[int, int], crop_box=None, orig_box=None,
               box_scale=None) -> Dict:
    """Grid prompts -> filtered, NMS'd top-K candidates.  image_embedding
    (1, G, G, C); points (P, 2) input-frame pixels; valid_hw the image's
    extent.  In the crop cascade, ``crop_box`` and ``orig_box`` are xyxy in
    the full image's pixels and ``box_scale`` (sx, sy) maps this frame's
    boxes to the crop's pixels: a candidate whose box touches the crop's
    edge but not the image's is dropped before the NMS.  Returns K =
    max_masks rows: masks_low (K, S, S) bf16, iou, stability, boxes (K, 4)
    input-frame xyxy, points (K, 2), valid (K,)."""
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
    if crop_box is not None:
        sc = torch.as_tensor(box_scale, dtype=torch.float32, device=boxes.device).repeat(2)
        keep &= ~amg_utils.is_box_near_crop_edge(boxes * sc, crop_box, orig_box)
    keep_nms = nms.nms(boxes, iou_pred, amg.box_nms_thresh, valid=keep)
    score = torch.where(keep_nms, iou_pred, -torch.inf)
    top = torch.argsort(-score, stable=True)[:amg.max_masks]
    return {"masks_low": masks[top], "iou": iou_pred[top], "stability": stability[top],
            "boxes": boxes[top], "points": point_per_mask[top], "valid": keep_nms[top]}


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(K, H, W) 0/1 -> (K, H, ceil(W / 8)) uint8, MSB first, the last byte
    zero-padded."""
    K, H, W = bits.shape
    bits = torch.nn.functional.pad(bits.int(), (0, (-W) % 8)).reshape(K, H, -1, 8)
    weights = 2 ** torch.arange(7, -1, -1, device=bits.device, dtype=torch.int32)
    return (bits * weights).sum(-1).to(torch.uint8)


@torch.no_grad()
def upscale_binary(masks_low: torch.Tensor, out_hw: Tuple[int, int], threshold: float = 0.0,
                   bucket: Optional[int] = None) -> torch.Tensor:
    """(K, S, S) logits -> (K, H, W // 8) bit-packed (MSB first) masks at
    the input-frame resolution."""
    if bucket is not None:
        masks_low = masks_low[:bucket]
    return _pack_bits(amg_utils.resize_bilinear(masks_low, out_hw) > threshold)


@torch.no_grad()
def upscale_crop_binary(masks_low: torch.Tensor, rhw: Tuple[int, int], chw: Tuple[int, int],
                        s_in: int, threshold: float = 0.0,
                        bucket: Optional[int] = None) -> torch.Tensor:
    """(K, S, S) crop logits -> (K, ch, ceil(cw / 8)) bit-packed masks at the
    crop's own extent: low -> (s_in, s_in), the valid (rh, rw) sliced,
    -> (ch, cw) (antialiased where it shrinks), thresholded, the width
    padded to a multiple of 8 and packed."""
    if bucket is not None:
        masks_low = masks_low[:bucket]
    up = amg_utils.resize_bilinear(masks_low, (s_in, s_in))[:, :rhw[0], :rhw[1]]
    return _pack_bits(amg_utils.resize_bilinear(up, chw) > threshold)


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
            return self._submit_crops(image)
        return {"out": self._submit_one(image, self._grid), "hw": (h, w)}

    def _submit_one(self, image: np.ndarray, grid: np.ndarray, crop_box=None,
                    orig_hw=None) -> Dict:
        """Encode + select one frame: the image, or one resized crop of it.
        grid (P, 2) in [0, 1]."""
        h, w = image.shape[:2]
        s_in = self.cfg.encoder.img_size
        padded = np.zeros((s_in, s_in, 3), image.dtype)
        padded[:h, :w] = image
        # normalise, then zero outside the image, as the reference pads
        region = torch.zeros(1, s_in, s_in, 1, device=self.device)
        region[:, :h, :w] = 1.0
        x = torch.from_numpy(padded)[None].to(self.device)
        emb = sam_lib.encode_image(self.model, sam_lib.preprocess(x, self.cfg) * region)
        points = torch.tensor(grid * np.array([w, h]), dtype=torch.float32, device=self.device)
        kw = {}
        if crop_box is not None:
            x0, y0, x1, y1 = crop_box
            kw = dict(crop_box=crop_box, orig_box=(0, 0, orig_hw[1], orig_hw[0]),
                      box_scale=((x1 - x0) / w, (y1 - y0) / h))
        return amg_select(self.model, self.amg, emb, points, (h, w), **kw)

    def _submit_crops(self, image: np.ndarray) -> Dict:
        """The crop cascade: the full frame and 4^i overlapping crops a
        layer, each resized so that its longest side is the SAM input (as
        the reference's predictor does) and selected on its layer's grid;
        the cross-crop dedup is ``finish``'s."""
        h, w = image.shape[:2]
        s_in = self.cfg.encoder.img_size
        crop_boxes, layer_idxs = amg_utils.generate_crop_boxes(
            (h, w), self.amg.crop_n_layers, self.amg.crop_overlap_ratio)
        grids = amg_utils.build_all_layer_point_grids(
            self.amg.points_per_side, self.amg.crop_n_layers,
            self.amg.crop_n_points_downscale_factor)
        crops = []
        for (x0, y0, x1, y1), layer in zip(crop_boxes, layer_idxs):
            crop = image[y0:y1, x0:x1]
            if max(crop.shape[:2]) != s_in:
                crop = image_ops.resize_longest_side(crop, s_in)
            out = self._submit_one(crop, grids[layer], crop_box=(x0, y0, x1, y1),
                                   orig_hw=(h, w))
            crops.append({"out": out, "crop_box": (x0, y0, x1, y1), "rhw": crop.shape[:2]})
        return {"crops": crops, "hw": (h, w)}

    def _bucket(self, n: int) -> int:
        return min(max(8, 1 << (n - 1).bit_length()), self.amg.max_masks)

    @staticmethod
    def _pull_survivors(out: Dict):
        """One frame's survivor count and metadata, on the host."""
        small = {k: out[k].float().cpu().numpy() for k in ("iou", "stability", "boxes", "points")}
        small["valid"] = out["valid"].cpu().numpy()
        return int(small["valid"].sum()), small

    @torch.inference_mode()
    def prefetch(self, handle: Dict) -> Dict:
        """Pull the survivor metadata and enqueue the survivors' upscale
        (run boundaries on the device, or bit-packed bitmaps when small
        regions are cleaned; in the crop cascade, each crop's bitmaps at
        its own extent).  Idempotent; ``finish`` calls it."""
        if "crops" in handle:
            if "staged" not in handle:
                handle["staged"] = self._stage_crops(handle)
            return handle
        if "n" in handle:
            return handle
        out = handle["out"]
        n, small = self._pull_survivors(out)
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
        if "crops" in handle:
            return self._assemble(*self._finish_crops(handle), h, w)
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

    def _stage_crops(self, handle: Dict) -> List:
        """Each crop's survivors: their metadata, their points in the full
        image's pixels, and their bit-packed masks at the crop's extent
        (enqueued on the device)."""
        s_in = self.cfg.encoder.img_size
        staged = []
        for c in handle["crops"]:
            out = c["out"]
            n, small = self._pull_survivors(out)
            if n == 0:
                continue
            x0, y0, x1, y1 = box = c["crop_box"]
            rh, rw = c["rhw"]
            scale = torch.tensor([(x1 - x0) / rw, (y1 - y0) / rh], dtype=torch.float32)
            pts = amg_utils.uncrop_points(torch.from_numpy(small["points"][:n]) * scale, box)
            packed = upscale_crop_binary(out["masks_low"], (rh, rw), (y1 - y0, x1 - x0), s_in,
                                         self.cfg.mask_threshold, bucket=self._bucket(n))
            staged.append((box, n, small, pts.numpy(), packed))
        return staged

    def _finish_crops(self, handle: Dict):
        """Every crop's nonempty survivors on full-image canvases, then the
        cross-crop NMS (run when there is more than one crop) that scores a
        mask 1 / its crop's area, so the smaller crop's mask wins; the kept
        ones stay in their order.  Returns (masks, iou, stability, points,
        crop boxes)."""
        h, w = handle["hw"]
        all_masks, all_iou, all_stab, all_pts, all_crop = [], [], [], [], []
        for box, n, small, pts, packed in handle["staged"]:
            x0, y0, x1, y1 = box
            bits = np.unpackbits(packed.cpu().numpy()[:n], axis=-1, count=x1 - x0).astype(bool)
            for i in range(n):
                if not bits[i].any():
                    continue
                canvas = np.zeros((h, w), bool)
                canvas[y0:y1, x0:x1] = bits[i]
                all_masks.append(canvas)
                all_iou.append(small["iou"][i])
                all_stab.append(small["stability"][i])
                all_pts.append(pts[i])
                all_crop.append(box)
        if not all_masks:
            return [], [], [], [], []
        masks, iou, stability, pts = (np.stack(all_masks), np.asarray(all_iou),
                                      np.asarray(all_stab), np.asarray(all_pts))
        if len(handle["crops"]) > 1:
            scores = np.asarray([1.0 / ((cb[2] - cb[0]) * (cb[3] - cb[1])) for cb in all_crop])
            keep = np.sort(amg_utils.nms_host(_mask_boxes_np(masks), scores,
                                              self.amg.crop_nms_thresh))
            masks, iou, stability, pts = masks[keep], iou[keep], stability[keep], pts[keep]
            all_crop = [all_crop[i] for i in keep]
        return masks, iou, stability, pts, all_crop

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
