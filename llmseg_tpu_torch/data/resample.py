"""Host resamplers that give what the JAX data path gets from PIL and cv2,
without either library: the card's machine has neither.

``pil_resize`` is ``PIL.Image.resize(..., BILINEAR | BICUBIC)`` of a uint8
image (no ``reducing_gap``), to the bit.  It follows Pillow's
``src/libImaging/Resample.c``:

* ``precompute_coeffs``: ``filterscale = max(in / out, 1)``, ``support =
  filter_support * filterscale``; output ``x`` is centred at ``(x + 0.5) *
  scale``; its taps run from ``int(center - support + 0.5)`` to
  ``int(center + support + 0.5)``, clipped to the image; tap ``i`` weighs
  ``filter((i - center + 0.5) / filterscale)``, and the weights are divided
  by their sum (summed in tap order, in double);
* ``normalize_coeffs_8bpc``: each weight becomes fixed point with 22
  fraction bits, rounded half away from zero;
* ``ImagingResampleHorizontal_8bpc`` / ``...Vertical_8bpc``: each sum
  starts at ``1 << 21``, is shifted right by 22 and clipped to 0..255; the
  horizontal pass runs first (only if the width changes) and rounds to
  uint8, then the vertical pass (only if the height changes).

The integer sums are exact, so their order does not matter.

``cv2_resize`` is ``cv2.resize`` of a float32 image, ``INTER_AREA`` when
shrinking and ``INTER_LINEAR`` otherwise, within float32 rounding: the
weights are cv2's (``computeResizeAreaTab``'s overlap of each source cell
with the output cell, stored as float32 as cv2 stores them;
``INTER_LINEAR``'s ``fx = (dx + 0.5) * scale - 0.5`` with clamped
borders), and the sums are taken in float64 on the input's values, where
cv2 rounds the input to float32 and sums in float32.  On masks in [0, 1]
the two agree within 1e-6.

Both are separable: one weight table per axis, applied as a loop over the
taps (at most ``2 ceil(support) + 1``), each a gather along the axis.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import numpy as np
import torch

PRECISION_BITS = 32 - 8 - 2      # Resample.c


def _bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic with a = -0.5, evaluated in Resample.c's order."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


PIL_FILTERS = {"bilinear": (_bilinear, 1.0), "bicubic": (_bicubic, 2.0)}


def pil_coeffs(in_size: int, out_size: int, filt: Callable, filter_support: float
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc``: per
    output index, the first tap (``xmin``, (out,) int64) and the fixed-point
    weights of ``ksize`` taps ((out, ksize) int64, zero past the image)."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = filter_support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(np.int64) - xmin
    taps = np.arange(ksize)
    live = taps[None, :] < xmax[:, None]
    w = np.where(live, filt(((taps[None, :] + xmin[:, None]) - center[:, None] + 0.5)
                            * (1.0 / filterscale)), 0.0)
    ww = np.zeros(out_size)
    for j in range(ksize):          # the C loop's order
        ww = ww + w[:, j]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    one = float(1 << PRECISION_BITS)
    k = np.where(w < 0, np.trunc(-0.5 + w * one), np.trunc(0.5 + w * one))
    return xmin, k.astype(np.int64)


def _apply_taps(x: torch.Tensor, axis: int, first: np.ndarray, taps: np.ndarray
                ) -> torch.Tensor:
    """sum_j taps[:, j] * x[first + j] along ``axis``: a gather and a
    multiply-add per tap (CPU torch, which spreads each over the cores and
    lets other threads run)."""
    in_size = x.shape[axis]
    shape = [1] * x.dim()
    shape[axis] = len(first)
    w = torch.from_numpy(np.ascontiguousarray(taps))
    first = torch.from_numpy(first)
    acc = None
    for j in range(w.shape[1]):
        src = x.index_select(axis, torch.clamp(first + j, max=in_size - 1))
        term = src * w[:, j].reshape(shape)
        acc = term if acc is None else acc.add_(term)
    return acc


def _pil_pass(img: torch.Tensor, axis: int, xmin: np.ndarray, k: np.ndarray) -> torch.Tensor:
    """One 8bpc pass along ``axis`` of a uint8 tensor."""
    acc = _apply_taps(img.long(), axis, xmin, k).add_(1 << (PRECISION_BITS - 1))
    return acc.bitwise_right_shift_(PRECISION_BITS).clamp_(0, 255).to(torch.uint8)


def pil_resize(image: np.ndarray, size: Tuple[int, int], resample: str = "bilinear"
               ) -> np.ndarray:
    """``np.asarray(Image.fromarray(image).resize((w, h), resample))`` for a
    uint8 (H, W) or (H, W, C) image; ``size`` is (h, w)."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise TypeError(f"pil_resize takes uint8, not {image.dtype}")
    filt, support = PIL_FILTERS[resample]
    out_h, out_w = size
    in_h, in_w = image.shape[:2]
    out = torch.from_numpy(image)
    if out_w != in_w:
        out = _pil_pass(out, 1, *pil_coeffs(in_w, out_w, filt, support))
    if out_h != in_h:
        out = _pil_pass(out, 0, *pil_coeffs(in_h, out_h, filt, support))
    return out.numpy().copy() if (out_h, out_w) == (in_h, in_w) else out.numpy()


# ---------------------------------------------------------------------------
# cv2.resize of float32: INTER_AREA (shrinking), INTER_LINEAR (otherwise)
# ---------------------------------------------------------------------------


def area_weights(s: int, d: int) -> np.ndarray:
    """``computeResizeAreaTab`` as a (d, s) matrix: the overlap of source
    cell ``sx`` with output cell ``dx``, over the cell's width."""
    scale = 1.0 / (d / s)
    w = np.zeros((d, s))
    for dx in range(d):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, s - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, s - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            w[dx, sx1 - 1] += np.float32((sx1 - fsx1) / cell)
        for sx in range(sx1, sx2):
            w[dx, sx] += np.float32(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            w[dx, sx2] += np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return w


def linear_weights(s: int, d: int) -> np.ndarray:
    """``INTER_LINEAR``'s weights as a (d, s) matrix: ``fx = (dx + 0.5) *
    scale - 0.5`` in double, taps ``floor(fx)`` and the next with ``1 -
    frac``, ``frac``; clamped to the first and last pixel.  (cv2 5.0 on a
    2-D float32 image takes the coordinate in double: weights from a
    float32 ``fx`` miss it by up to ulp(fx).)"""
    scale = 1.0 / (d / s)
    w = np.zeros((d, s))
    for dx in range(d):
        fx = (dx + 0.5) * scale - 0.5
        sx = math.floor(fx)
        fx -= sx
        if sx < 0:
            fx, sx = 0.0, 0
        if sx >= s - 1:
            fx, sx = 0.0, s - 1
        w[dx, sx] += 1.0 - fx
        if fx != 0:
            w[dx, sx + 1] += fx
    return w


def _taps(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """A banded (d, s) matrix as per-row (first column, weights) taps."""
    nz = w != 0
    first = np.where(nz.any(1), nz.argmax(1), 0)
    last = np.where(nz.any(1), w.shape[1] - 1 - nz[:, ::-1].argmax(1), 0)
    n = int((last - first).max()) + 1
    cols = np.minimum(first[:, None] + np.arange(n), w.shape[1] - 1)
    taps = np.take_along_axis(w, cols, 1)
    taps[first[:, None] + np.arange(n) > last[:, None]] = 0.0
    return first, taps


def cv2_weights(s: int, d: int) -> np.ndarray:
    """The (d, s) weights of ``cv2.resize`` along one axis: INTER_AREA when
    ``d < s``, else INTER_LINEAR (identity when ``d == s``)."""
    return area_weights(s, d) if d < s else linear_weights(s, d)


def cv2_resize(x: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(x.astype(float32), (w, h), interpolation=INTER_AREA if
    shrinking else INTER_LINEAR)`` for the leading (H, W) axes of ``x``
    (trailing axes are channels, each resized alike); ``size`` is (h, w).
    float32 out; a float64 input is read as it is (no copy when it is
    contiguous).  Shrinking one axis and growing the other is not what the
    data path does, and raises."""
    x = np.asarray(x)
    (h, w), (out_h, out_w) = x.shape[:2], size
    if (out_h < h) != (out_w < w) and (out_h, out_w) != (h, w):
        raise ValueError(f"cv2_resize: {h}x{w} -> {out_h}x{out_w} shrinks one axis only")
    y = torch.from_numpy(np.ascontiguousarray(x, np.float64))
    y = _apply_taps(y, 0, *_taps(cv2_weights(h, out_h)))
    y = _apply_taps(y, 1, *_taps(cv2_weights(w, out_w)))
    return y.to(torch.float32).numpy()
