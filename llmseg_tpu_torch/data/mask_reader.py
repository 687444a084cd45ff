"""Offline-AMG mask reader, a copy of ``llmseg_tpu.data.mask_reader``
(capability parity with reference utils/sam_mask_reader.py:11-113
SAM_Mask_Reader), with the segment resize computed by
``data.resample.cv2_resize`` instead of cv2.

Reads a masks.json produced by prepare_datasets (ours or the reference's —
same COCO-RLE schema), indexes by image name, and per image returns the
top-50-by-area proposals decoded, padded to square, plus original-resolution
masks and bboxes.  RLE decoding is the port's ``ops/rle.py``.
"""

from __future__ import annotations

import json
import time
from typing import Dict

import numpy as np

from llmseg_tpu_torch.data.resample import cv2_resize
from llmseg_tpu_torch.ops import rle as rle_lib


class SamMaskReader:
    def __init__(self, json_path: str, top_k: int = 50, verbose: bool = True):
        self.json_path = json_path
        self.top_k = top_k
        t0 = time.time()
        with open(json_path) as f:
            self.mask_list = json.load(f)
        self.index = {s["image"]: i for i, s in enumerate(self.mask_list)}
        if verbose:
            print(f"SamMaskReader: {len(self.mask_list)} images from "
                  f"{json_path} in {time.time() - t0:.1f}s")

    def __contains__(self, image_name: str) -> bool:
        return image_name in self.index

    @staticmethod
    def pad_to_square(masks: np.ndarray) -> np.ndarray:
        """(H, W, K) -> (S, S, K) float64, bottom/right zero pad
        (reference sam_mask_reader.py:49-66)."""
        h, w = masks.shape[:2]
        s = max(h, w)
        out = masks.astype(np.float64)
        return np.pad(out, ((0, s - h), (0, s - w), (0, 0)))

    def extract_sam_segs(self, image_name: str) -> Dict:
        if image_name not in self.index:
            raise ValueError(f"{image_name} not in sam mask index")
        sample = self.mask_list[self.index[image_name]]
        masks = sorted(sample["masks"], key=lambda m: m["area"], reverse=True)
        masks = masks[: self.top_k]
        if not masks:
            raise ValueError(f"{image_name}: no proposals")
        decoded = [rle_lib.decode(m["segmentation"]) for m in masks]
        segs_origin = np.stack(decoded, axis=-1)          # (H, W, K)
        return {
            "segs_square": self.pad_to_square(segs_origin),
            "segs_origin": segs_origin,
            "bbox": [m["bbox"] for m in masks],
        }


def resize_segs_bilinear(segs_square: np.ndarray, size: int) -> np.ndarray:
    """(S, S, K) -> (K, size, size) float32 antialiased bilinear resize
    (reference reason_seg_dataset.py:169-173 uses torch antialias bilinear;
    cv2.INTER_AREA is the equivalent antialiased downsample, INTER_LINEAR
    the upsample): ``cv2_resize``, all K at once."""
    return np.ascontiguousarray(cv2_resize(segs_square, (size, size)).transpose(2, 0, 1))
