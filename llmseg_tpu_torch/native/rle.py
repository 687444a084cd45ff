"""The native RLE codec (``native/rle.cc``): built with ``g++`` at first use
into ``llmseg_tpu_torch/_build/librle.so`` and loaded with ``ctypes``, the
counterpart of ``llmseg_tpu.native.loader``.

``ops/rle.py`` takes it for ``mask_to_counts``, ``counts_to_mask``,
``encode_packed`` and ``counts_to_string`` (over 8 counts), as the JAX
package does.  ``LLMSEG_NO_NATIVE=1`` (the JAX package's knob) picks the
numpy path instead.  A failed build raises with the compiler's output; it
does not fall back.  Nothing builds at import time.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import List, Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "rle.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
LIB_PATH = BUILD_DIR / "librle.so"

_lib: Optional[ctypes.CDLL] = None
_I64, _F32 = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_float)
_U8 = ctypes.POINTER(ctypes.c_uint8)
_SIGNATURES = {
    "rle_mask_to_counts": (ctypes.c_int64, [_U8, ctypes.c_int64, ctypes.c_int64, _I64]),
    "rle_counts_to_mask": (ctypes.c_int, [_I64, ctypes.c_int64, ctypes.c_int64,
                                          ctypes.c_int64, _U8]),
    "rle_packed_encode": (ctypes.c_int64, [_U8, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                                           ctypes.c_char_p, _I64,
                                           ctypes.POINTER(ctypes.c_double)]),
    "rle_counts_to_string": (ctypes.c_int64, [_I64, ctypes.c_int64, ctypes.c_char_p]),
    "mask_iou_iop": (None, [_U8, _U8, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                            _F32, _F32]),
}


def enabled() -> bool:
    """Whether ``ops/rle.py`` takes the native codec (not switched off by
    ``LLMSEG_NO_NATIVE``)."""
    return not os.environ.get("LLMSEG_NO_NATIVE")


def build(force: bool = False) -> Path:
    """Compile ``rle.cc`` unless the library is newer; raises with g++'s
    output on failure.  The library is written under a name of this
    process and renamed, so concurrent builds do not clash."""
    if not force and LIB_PATH.exists() and LIB_PATH.stat().st_mtime >= SOURCE.stat().st_mtime:
        return LIB_PATH
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = BUILD_DIR / f"librle.{os.getpid()}.so"
    cmd = [os.environ.get("CXX", "g++"), "-O3", "-fPIC", "-shared", "-std=c++17",
           "-march=native", "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building the native RLE codec failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


def library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (res, args) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
        _lib = lib
    return _lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(_U8)


def mask_to_counts(mask: np.ndarray) -> List[int]:
    """(H, W) uint8 C-order -> column-major run lengths, the first of zeros."""
    h, w = mask.shape
    out = np.empty(h * w + 1, np.int64)
    n = library().rle_mask_to_counts(_u8(mask), h, w, out.ctypes.data_as(_I64))
    return out[:n].tolist()


def counts_to_mask(counts: np.ndarray, h: int, w: int) -> np.ndarray:
    out = np.zeros((h, w), np.uint8)
    rc = library().rle_counts_to_mask(counts.ctypes.data_as(_I64), len(counts), h, w, _u8(out))
    if rc != 0:
        raise ValueError(f"RLE sums to {int(np.sum(counts))}, expected {h * w}")
    return out


def _buffer(n_counts: int) -> np.ndarray:
    # at most 13 varint characters a count (a 64-bit delta), and the NUL
    return np.empty((n_counts + 1) * 13 + 1, np.uint8)


def packed_encode(packed: np.ndarray, h: int, w: int):
    """Bit-packed (h_pad, stride) uint8 mask (MSB first) -> (counts string,
    area, inclusive-edge bbox [x, y, dw, dh]) of its top-left (h, w) crop,
    in one pass that never unpacks it."""
    buf = _buffer(h * w + 1)
    area = ctypes.c_int64()
    bbox = (ctypes.c_double * 4)()
    n = library().rle_packed_encode(_u8(packed), packed.shape[1], h, w,
                                    buf.ctypes.data_as(ctypes.c_char_p), ctypes.byref(area),
                                    bbox)
    return buf[:n].tobytes().decode("ascii"), int(area.value), list(bbox)


def counts_to_string(counts: np.ndarray) -> str:
    """int64 counts -> the pycocotools varint string."""
    counts = np.ascontiguousarray(counts, np.int64)
    buf = _buffer(len(counts))
    n = library().rle_counts_to_string(counts.ctypes.data_as(_I64), len(counts),
                                       buf.ctypes.data_as(ctypes.c_char_p))
    return buf[:n].tobytes().decode("ascii")


def mask_iou_iop(gt: np.ndarray, props: np.ndarray):
    """gt (H, W) uint8, props (K, H, W) uint8 -> (iou (K,), iop (K,))
    float32, iop = intersection / proposal area."""
    k, h, w = props.shape
    iou, iop = np.empty(k, np.float32), np.empty(k, np.float32)
    library().mask_iou_iop(_u8(np.ascontiguousarray(gt, np.uint8)),
                           _u8(np.ascontiguousarray(props, np.uint8)), k, h, w,
                           iou.ctypes.data_as(_F32), iop.ctypes.data_as(_F32))
    return iou, iop
