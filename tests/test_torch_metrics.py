"""The port's IoU / IoP label functions against ``llmseg_tpu.utils.metrics``
on the same numpy inputs from a seed.  The port copies the JAX module's
numpy path, so it must give the same bits as that path (the native library
switched off); the JAX module's default path takes the native library
where it is built, whose float32 divisions may differ in the last place:
within 1e-7."""

import numpy as np
import pytest

from llmseg_tpu.native import loader as jnative
from llmseg_tpu.utils import metrics as jmetrics
from llmseg_tpu_torch.utils import metrics as tmetrics

# (proposal grid, ground-truth grid, K): equal shapes, up- and downsampled
SHAPES = [((40, 50), (40, 50), 6), ((30, 45), (61, 37), 8), ((64, 64), (17, 23), 3),
          ((7, 9), (7, 9), 1)]


def _inputs(hw, gt_hw, K, seed):
    rng = np.random.RandomState(seed)
    segs = (rng.rand(*hw, K) < 0.4).astype(np.uint8)
    segs[..., 0] = 0                       # an empty proposal
    gt = (rng.rand(*gt_hw) < 0.3).astype(np.float32)
    return segs, gt


@pytest.fixture
def numpy_path(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)


@pytest.mark.parametrize("hw,gt_hw,K", SHAPES)
def test_nearest_resize_matches_jax(hw, gt_hw, K):
    _, gt = _inputs(hw, gt_hw, K, seed=0)
    for out in (hw, gt_hw, (1024, 1024), (1, 3)):
        np.testing.assert_array_equal(tmetrics._nearest_resize(gt, out),
                                      jmetrics._nearest_resize(gt, out))


@pytest.mark.parametrize("seed", [0, 1])
def test_compute_iou_iop_match_jax(seed):
    segs, gt = _inputs((40, 50), (40, 50), 6, seed)
    for k in range(segs.shape[-1]):
        assert tmetrics.compute_iou(segs[..., k], gt) == jmetrics.compute_iou(segs[..., k], gt)
        assert tmetrics.compute_iop(segs[..., k], gt) == jmetrics.compute_iop(segs[..., k], gt)
    empty = np.zeros((4, 4))
    assert tmetrics.compute_iou(empty, empty) == jmetrics.compute_iou(empty, empty) == 0.0
    assert tmetrics.compute_iop(empty, gt[:4, :4]) == jmetrics.compute_iop(empty, gt[:4, :4])


@pytest.mark.parametrize("hw,gt_hw,K", SHAPES)
def test_compute_all_iou_iop_matches_jax_numpy_path(hw, gt_hw, K, numpy_path):
    segs, gt = _inputs(hw, gt_hw, K, seed=3)
    got = tmetrics.compute_all_iou_iop(segs, gt)
    ref = jmetrics.compute_all_iou_iop(segs, gt)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype == np.float32
        np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(tmetrics.compute_all_iou(segs, gt), ref[0])
    np.testing.assert_array_equal(tmetrics.compute_all_iop(segs, gt), ref[1])


@pytest.mark.parametrize("hw,gt_hw,K", SHAPES)
def test_compute_all_iou_iop_matches_jax_default_path(hw, gt_hw, K):
    segs, gt = _inputs(hw, gt_hw, K, seed=4)
    for g, r in zip(tmetrics.compute_all_iou_iop(segs, gt), jmetrics.compute_all_iou_iop(segs, gt)):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-7)


@pytest.mark.parametrize("K", [2, 3])
def test_intersection_and_union_matches_jax(K):
    rng = np.random.RandomState(K)
    out = rng.randint(0, K, (33, 41))
    tgt = rng.randint(0, K, (33, 41))
    tgt[rng.rand(33, 41) < 0.1] = 255          # ignored pixels
    got = tmetrics.intersection_and_union(out, tgt, K)
    ref = jmetrics.intersection_and_union(out, tgt, K)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype == np.float64
        np.testing.assert_array_equal(g, r)


def test_meter_all_reduce_is_a_no_op_in_one_process():
    m = tmetrics.AverageMeter("x", ":.3f", tmetrics.Summary.SUM)
    m.update(np.array([1.0, 2.0]))
    m.update(np.array([3.0, 5.0]))
    m.all_reduce()
    np.testing.assert_array_equal(m.sum, [4.0, 7.0])
    assert m.count == 2.0
