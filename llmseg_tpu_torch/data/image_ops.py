"""Host-side image preprocessing, a copy of ``llmseg_tpu.data.image_ops``
with the two resizes computed by ``data.resample`` (PIL's bilinear and
bicubic to the bit), so that neither PIL nor cv2 is needed.

gIoU parity depends on matching the reference's exact resize kernels
(SURVEY.md §7 'Bit-compat preprocessing'):
  * SAM/DINO path: ResizeLongestSide via PIL bilinear
    (reference model/segment_anything/utils/transforms.py:17-113), then
    normalize + bottom/right pad to square (reason_seg_dataset.py preprocess).
  * CLIP path: CLIPImageProcessor for openai/clip-vit-large-patch14 —
    shortest-edge 224 bicubic resize, center crop, rescale 1/255, CLIP
    mean/std normalize.

Outputs are NHWC float32, as the JAX package's (the models take NHWC).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from llmseg_tpu_torch.data.resample import pil_resize

SAM_PIXEL_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
SAM_PIXEL_STD = np.array([58.395, 57.12, 57.375], np.float32)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def get_preprocess_shape(h: int, w: int, long_side: int) -> Tuple[int, int]:
    """reference transforms.py:102-113."""
    scale = long_side * 1.0 / max(h, w)
    newh, neww = h * scale, w * scale
    return int(newh + 0.5), int(neww + 0.5)


def resize_longest_side(image: np.ndarray, long_side: int) -> np.ndarray:
    """(H, W, 3) uint8 -> PIL bilinear resize, longest side == long_side
    (reference transforms.py:27-34 apply_image)."""
    h, w = image.shape[:2]
    newh, neww = get_preprocess_shape(h, w, long_side)
    return pil_resize(image, (newh, neww), "bilinear")


def apply_coords(coords: np.ndarray, original_hw: Tuple[int, int],
                 long_side: int) -> np.ndarray:
    """reference transforms.py:36-50."""
    old_h, old_w = original_hw
    new_h, new_w = get_preprocess_shape(old_h, old_w, long_side)
    coords = coords.astype(np.float64).copy()
    coords[..., 0] = coords[..., 0] * (new_w / old_w)
    coords[..., 1] = coords[..., 1] * (new_h / old_h)
    return coords


def apply_boxes(boxes: np.ndarray, original_hw: Tuple[int, int],
                long_side: int) -> np.ndarray:
    b = apply_coords(boxes.reshape(-1, 2, 2), original_hw, long_side)
    return b.reshape(-1, 4)


def preprocess_dino(image: np.ndarray, img_size: int = 896
                    ) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Resize longest side -> normalize -> pad to square.
    Returns ((img_size, img_size, 3) float32, resized (h, w))."""
    resized = resize_longest_side(image, img_size)
    h, w = resized.shape[:2]
    x = (resized.astype(np.float32) - SAM_PIXEL_MEAN) / SAM_PIXEL_STD
    out = np.zeros((img_size, img_size, 3), np.float32)
    out[:h, :w] = x
    return out, (h, w)


def preprocess_clip(image: np.ndarray, size: int = 224) -> np.ndarray:
    """CLIPImageProcessor-equivalent: shortest-edge bicubic resize, center
    crop, 1/255 rescale, normalize.  (H, W, 3) uint8 -> (size, size, 3) f32."""
    h, w = image.shape[:2]
    short, long = (h, w) if h < w else (w, h)
    new_short = size
    new_long = int(size * long / short)
    newh, neww = (new_short, new_long) if h < w else (new_long, new_short)
    arr = pil_resize(image, (newh, neww), "bicubic")
    top = (newh - size) // 2
    left = (neww - size) // 2
    arr = arr[top:top + size, left:left + size]
    x = arr.astype(np.float32) / 255.0
    return (x - CLIP_MEAN) / CLIP_STD
