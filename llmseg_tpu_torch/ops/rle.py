"""COCO run-length encoding, pycocotools-compatible: the counterpart of
``llmseg_tpu.ops.rle`` (its numpy path).  Runs are column-major and the
first run counts zeros; ``counts`` strings use pycocotools' delta and 5-bit
varint encoding."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

RLE = Dict  # {"size": [H, W], "counts": str | list[int]}


def counts_to_string(counts: Sequence[int]) -> str:
    """Each count (after the third, minus the count two before it) as the
    fewest 5-bit groups that hold it in two's complement, low group first,
    bit 0x20 on every group but the last, offset by 48."""
    c = np.asarray(counts, np.int64).reshape(-1)
    if c.size == 0:
        return ""
    x = c.copy()
    x[3:] -= c[1:-2]
    # x fits k groups iff its bit length without the sign, b, is <= 5k - 1
    n_groups = np.frexp(np.maximum(x, ~x).astype(np.float64))[1] // 5 + 1
    j = np.arange(n_groups.max())
    groups = (x[:, None] >> (5 * j)) & 0x1F
    groups |= (j < (n_groups - 1)[:, None]) << 5
    chars = (groups + 48)[j < n_groups[:, None]]
    return chars.astype(np.uint8).tobytes().decode("ascii")


def string_to_counts(s: str) -> List[int]:
    """The inverse of :func:`counts_to_string`."""
    if not s:
        return []
    c = np.frombuffer(s.encode("ascii"), np.uint8).astype(np.int64) - 48
    last = (c & 0x20) == 0
    starts = np.flatnonzero(np.concatenate([[True], last[:-1]]))
    j = np.arange(len(c)) - np.repeat(starts, np.diff(np.append(starts, len(c))))
    x = np.add.reduceat((c & 0x1F) << (5 * j), starts)
    width = 5 * (j[last] + 1)
    x -= np.where(c[last] & 0x10, np.left_shift(np.int64(1), width), 0)
    # undo the delta of every count after the third against the one two before
    x[1::2] = np.cumsum(x[1::2])
    x[2::2] = np.cumsum(x[2::2])
    return x.tolist()


def _runs(mask: np.ndarray) -> np.ndarray:
    """Binary (H, W) -> column-major run lengths (int64), the first run of zeros."""
    flat = np.asarray(mask, np.uint8).flatten(order="F")
    if flat.size == 0:
        return np.zeros(1, np.int64)
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    runs = np.diff(np.concatenate([[0], change, [flat.size]]))
    return np.concatenate([[0], runs]) if flat[0] == 1 else runs


def mask_to_counts(mask: np.ndarray) -> List[int]:
    """Binary (H, W) -> column-major run lengths, the first run of zeros."""
    return _runs(mask).tolist()


def counts_to_mask(counts: Sequence[int], h: int, w: int) -> np.ndarray:
    total = int(np.sum(counts))
    if total != h * w:
        raise ValueError(f"RLE sums to {total}, expected {h * w}")
    vals = np.zeros(len(counts), np.uint8)
    vals[1::2] = 1
    return np.repeat(vals, counts).reshape((h, w), order="F")


def encode(mask: np.ndarray) -> RLE:
    h, w = mask.shape
    return {"size": [h, w], "counts": counts_to_string(_runs(mask))}


def encode_stats(mask: np.ndarray):
    """Binary (H, W) mask -> (RLE, area, inclusive-edge xywh bbox
    [x_min, y_min, x_max - x_min, y_max - y_min], zeros when empty)."""
    h, w = mask.shape
    runs = _runs(mask)
    r = {"size": [h, w], "counts": counts_to_string(runs)}
    ys, xs = np.flatnonzero(mask.any(1)), np.flatnonzero(mask.any(0))
    if len(xs) == 0:
        bbox = [0.0, 0.0, 0.0, 0.0]
    else:
        bbox = [float(xs[0]), float(ys[0]), float(xs[-1] - xs[0]), float(ys[-1] - ys[0])]
    return r, int(runs[1::2].sum()), bbox


def encode_packed(packed: np.ndarray, h: int, w: int):
    """Bit-packed (MSB first) mask -> :func:`encode_stats` of its top-left
    (h, w) crop."""
    packed = np.ascontiguousarray(packed, np.uint8)
    return encode_stats(np.unpackbits(packed, axis=-1, count=packed.shape[1] * 8)[:h, :w])


def _counts(rle: RLE) -> List[int]:
    counts = rle["counts"]
    if isinstance(counts, bytes):
        counts = counts.decode("utf-8")
    return string_to_counts(counts) if isinstance(counts, str) else list(counts)


def decode(rle: RLE) -> np.ndarray:
    h, w = rle["size"]
    return counts_to_mask(_counts(rle), h, w)


def area(rle: RLE) -> int:
    return int(np.sum(np.asarray(_counts(rle)[1::2], np.int64)))


def to_bbox(rle: RLE) -> np.ndarray:
    """xywh bbox like pycocotools toBbox."""
    ys, xs = np.nonzero(decode(rle))
    if len(xs) == 0:
        return np.zeros(4, np.float32)
    return np.array([xs.min(), ys.min(), xs.max() - xs.min() + 1,
                     ys.max() - ys.min() + 1], np.float32)


def merge(rles: List[RLE]) -> RLE:
    """Union of masks."""
    out = decode(rles[0])
    for r in rles[1:]:
        out = np.maximum(out, decode(r))
    return encode(out)
