"""Run-length encoding of upscaled AMG masks on the device, the counterpart
of ``llmseg_tpu.ops.device_rle``.  The card computes each mask's
column-major run boundaries and metadata, so the host downloads boundary
indices (int16) instead of bitmaps:

  payload16 (K, S*max_per_col + S): per column the boundary rows (S when
    the slot is empty), then the per-column boundary counts;
  meta32 (K, 7): area, x0, y0, x1, y1 (inclusive), first bit, overflow.

A column with more than ``max_per_col`` boundaries sets the overflow flag
and the caller takes the bit-packed path for that mask.  The 256 -> 1024
resize is an upsample, so it needs no antialiasing."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from llmseg_tpu_torch.ops import rle
from llmseg_tpu_torch.ops.amg_utils import resize_bilinear


@torch.no_grad()
def upscale_rle(masks_low: torch.Tensor, hw: Tuple[int, int], out_hw: Tuple[int, int],
                threshold: float = 0.0, bucket: int = 64, max_per_col: int = 8):
    """(K0, S0, S0) logits -> (payload16, meta32) of the first ``bucket``
    masks, upscaled to the square input and cut to the (h, w) crop."""
    h, w = hw
    S = out_hw[0]
    if out_hw[0] != out_hw[1]:
        raise ValueError("square SAM input expected")
    bits = resize_bilinear(masks_low[:bucket], (S, S)) > threshold   # (K, S, S)
    K = bits.shape[0]
    dev = bits.device
    rows = torch.arange(S, dtype=torch.int32, device=dev)
    valid = (rows[:, None] < h) & (rows[None, :] < w)
    bits = bits & valid
    # previous element in Fortran order: (i-1, j), or (h-1, j-1) at a column's top
    prev_row = torch.nn.functional.pad(bits[:, :-1, :], (0, 0, 1, 0))
    prev_col = torch.nn.functional.pad(bits[:, h - 1, :-1], (1, 0))
    prev = torch.where(rows[None, :, None] > 0, prev_row, prev_col[:, None, :])
    start = (rows[:, None] == 0) & (rows[None, :] == 0)
    boundary = valid & (start[None] | (bits != prev))
    b32 = boundary.int()
    rank = torch.cumsum(b32, 1) - b32
    slots = [torch.where(boundary & (rank == s), rows[None, :, None], S).amin(1)
             for s in range(max_per_col)]
    pos = torch.stack(slots, -1).to(torch.int16)                 # (K, S, P)
    col_counts = b32.sum(1)
    overflow = (col_counts > max_per_col).any(-1)
    area = bits.sum((1, 2), dtype=torch.int32)
    rows_any, cols_any = bits.any(2), bits.any(1)
    y0 = torch.where(rows_any, rows, S).amin(1)
    y1 = torch.where(rows_any, rows, -1).amax(1)
    x0 = torch.where(cols_any, rows, S).amin(1)
    x1 = torch.where(cols_any, rows, -1).amax(1)
    first_bit = bits[:, 0, 0].int()
    payload16 = torch.cat([pos.reshape(K, S * max_per_col), col_counts.to(torch.int16)], 1)
    meta32 = torch.stack([area, x0, y0, x1, y1, first_bit, overflow.int()], 1).int()
    return payload16, meta32


def decode_boundaries(payload16_row: np.ndarray, h: int, w: int, s_in: int,
                      max_per_col: int) -> list:
    """One mask's payload row -> pycocotools counts."""
    pos = payload16_row[:s_in * max_per_col].reshape(s_in, max_per_col)
    col_counts = payload16_row[s_in * max_per_col:].astype(np.int64)
    ncols = min(w, s_in)
    slot_valid = np.arange(max_per_col)[None, :] < col_counts[:ncols, None]
    i_flat = pos[:ncols].astype(np.int64)[slot_valid]
    j_flat = np.broadcast_to(np.arange(ncols)[:, None], (ncols, max_per_col))[slot_valid]
    q = j_flat * h + i_flat
    if q.size == 0:
        return [h * w]
    return np.diff(np.append(q, h * w)).tolist()


def annotations_from_rle_payload(payload16: np.ndarray, meta32: np.ndarray, n: int, h: int,
                                 w: int, s_in: int, max_per_col: int):
    """(payload16, meta32) on the host -> per mask (rle, area, bbox), or None
    where the mask needs the bit-packed path."""
    out = []
    for k in range(n):
        area, x0, y0, x1, y1, first_bit, overflow = (int(v) for v in meta32[k])
        if overflow:
            out.append(None)
            continue
        if area == 0:
            out.append(({"size": [h, w], "counts": rle.counts_to_string([h * w])}, 0,
                        [0.0, 0.0, 0.0, 0.0]))
            continue
        counts = decode_boundaries(payload16[k], h, w, s_in, max_per_col)
        if first_bit:
            counts = [0] + counts
        bbox = [float(x0), float(y0), float(x1 - x0), float(y1 - y0)]
        out.append(({"size": [h, w], "counts": rle.counts_to_string(counts)}, area, bbox))
    return out
