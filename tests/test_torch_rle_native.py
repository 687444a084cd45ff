"""The port's native RLE codec (``native/rle.cc`` built by
``native/rle.py``) against the port's numpy path and the JAX package's
``ops/rle.py`` (its native and numpy paths): counts, strings, masks, the
packed encode's (string, area, bbox) and ``mask_iou_iop``, exactly, on
masks drawn from a numpy seed (empty, full, one pixel, random blobs, odd
sizes, packed with padding), and the routing: ``LLMSEG_NO_NATIVE`` picks
the numpy path, short counts stay on it, a failed build raises."""

import numpy as np
import pytest

from llmseg_tpu.native import loader as jnative
from llmseg_tpu.ops import rle as jrle
from llmseg_tpu_torch.native import rle as native
from llmseg_tpu_torch.ops import rle as trle
from llmseg_tpu_torch.utils import metrics as tmetrics


def _masks():
    rng = np.random.default_rng(0)
    out = {"empty": np.zeros((7, 9), np.uint8), "full": np.ones((8, 5), np.uint8),
           "one_pixel": np.zeros((6, 6), np.uint8), "blobs": None,
           "noise": (rng.random((33, 17)) > 0.5).astype(np.uint8),
           "tall": (rng.random((131, 3)) > 0.9).astype(np.uint8)}
    out["one_pixel"][5, 0] = 1
    yy, xx = np.mgrid[:64, :80]
    out["blobs"] = (((yy - 20) ** 2 + (xx - 30) ** 2 < 150)
                    | ((yy - 45) ** 2 + (xx - 60) ** 2 < 90)).astype(np.uint8)
    return out


MASKS = _masks()


def _numpy_path(monkeypatch):
    monkeypatch.setenv("LLMSEG_NO_NATIVE", "1")
    monkeypatch.setattr(jnative, "available", lambda: False)


@pytest.mark.parametrize("name", list(MASKS))
def test_counts_and_masks_match_numpy_and_jax(name, monkeypatch):
    m = MASKS[name]
    got = trle.mask_to_counts(m)
    assert got == native.mask_to_counts(np.ascontiguousarray(m))
    assert got == jrle.mask_to_counts(m)
    enc = trle.encode(m)
    assert enc == jrle.encode(m)
    back = trle.counts_to_mask(got, *m.shape)
    np.testing.assert_array_equal(back, m)
    np.testing.assert_array_equal(trle.decode(enc), m)
    _numpy_path(monkeypatch)
    assert trle.mask_to_counts(m) == got and trle.encode(m) == enc
    np.testing.assert_array_equal(trle.counts_to_mask(got, *m.shape), m)
    assert jrle.mask_to_counts(m) == got


@pytest.mark.parametrize("name", list(MASKS))
@pytest.mark.parametrize("pad", [(0, 0), (3, 2)])
def test_encode_packed_matches_numpy_and_jax(name, pad, monkeypatch):
    m = MASKS[name]
    h, w = m.shape
    padded = np.zeros((h + pad[0], w + 8 * pad[1]), np.uint8)
    padded[:h, :w] = m
    padded[h:, :] = 1          # the padding is not encoded
    packed = np.packbits(padded, axis=-1)
    got = trle.encode_packed(packed, h, w)
    assert got == jrle.encode_packed(packed, h, w)
    _numpy_path(monkeypatch)
    assert trle.encode_packed(packed, h, w) == got
    assert jrle.encode_packed(packed, h, w) == got


@pytest.mark.parametrize("n", [0, 1, 3, 8, 9, 40, 1000])
def test_counts_to_string_matches_numpy_and_jax(n, monkeypatch):
    rng = np.random.default_rng(n)
    counts = rng.integers(0, 1 << rng.integers(1, 30), size=n).tolist()
    got = trle.counts_to_string(counts)
    assert got == jrle.counts_to_string(counts)
    if n:
        assert native.counts_to_string(np.asarray(counts)) == got
    assert trle.string_to_counts(got) == counts
    _numpy_path(monkeypatch)
    assert trle.counts_to_string(counts) == got


def test_mask_iou_iop_matches_jax_and_numpy():
    rng = np.random.default_rng(3)
    gt = (rng.random((40, 30)) > 0.6).astype(np.uint8)
    props = (rng.random((6, 40, 30)) > 0.5).astype(np.uint8)
    props[0] = 0                # an empty proposal: iop 0
    iou, iop = native.mask_iou_iop(gt, props)
    jiou, jiop = jnative.mask_iou_iop(gt, props)
    np.testing.assert_array_equal(iou, jiou)
    np.testing.assert_array_equal(iop, jiop)
    niou, niop = tmetrics.compute_all_iou_iop(props.transpose(1, 2, 0), gt)
    np.testing.assert_allclose(iou, niou, rtol=1e-7)
    np.testing.assert_allclose(iop, niop, rtol=1e-7)
    assert iop[0] == 0.0


def test_routing(monkeypatch):
    """Short counts and ``LLMSEG_NO_NATIVE`` stay on numpy (a build that
    would raise is never reached); a failed build raises, no fallback."""
    def refuse(*a, **k):
        raise AssertionError("native codec called")

    monkeypatch.setattr(native, "library", refuse)
    assert trle.counts_to_string([3, 4, 5]) == jrle.counts_to_string([3, 4, 5])
    monkeypatch.setenv("LLMSEG_NO_NATIVE", "1")
    m = MASKS["blobs"]
    assert trle.encode(m) == jrle.encode(m)
    monkeypatch.delenv("LLMSEG_NO_NATIVE")
    with pytest.raises(AssertionError, match="native codec called"):
        trle.encode(m)


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "librle.so")
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="native RLE codec failed"):
        native.build()
    assert not (tmp_path / "librle.so").exists()
