"""The greedy NMS kernel's plain version (``ops/nms.nms_bitmask_plain``: the
suppression bitmask, then the sweep in score order) and the fixpoint
iteration that ``nms.nms`` takes on the CPU, both against the JAX
package's ``llmseg_tpu.ops.nms.nms`` on the same inputs, bit for bit:
random boxes with tied scores, invalid entries, duplicate, zero-area and
inverted boxes, at thresholds that suppress everything that overlaps,
SAM's default, and nothing; sizes on and off the 64-bit words; IoUs on the
threshold.  The kernel itself is held to the plain sweep and the fixpoint
on the card in ``tests/test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmseg_tpu.ops import nms as jnms
from llmseg_tpu_torch.ops import nms as N

THRESHOLDS = (0.0, 0.5, 0.7, 1.1)


def _case(n, seed):
    """Boxes (n, 4) float32 with duplicates, zero-area and inverted boxes,
    scores rounded to one decimal (many ties), ~20 % invalid."""
    rng = np.random.RandomState(seed)
    xy = rng.rand(n, 2) * 60
    boxes = np.concatenate([xy, xy + rng.rand(n, 2) * 40], 1).astype(np.float32)
    if n > 4:
        boxes[3] = boxes[1]                       # a duplicate
        boxes[4, 2] = boxes[4, 0]                 # zero width
        boxes[2, 3] = boxes[2, 1] - 5             # inverted: clamped to zero area
    boxes = np.round(boxes)                       # integer edges, as AMG's boxes have
    scores = np.round(rng.rand(n), 1).astype(np.float32)
    valid = rng.rand(n) > 0.2
    return torch.tensor(boxes), torch.tensor(scores), torch.tensor(valid)


def _jax_nms(boxes, scores, thr, valid=None):
    """The JAX package's keep set on the same inputs, as a torch bool tensor."""
    keep = jnms.nms(jnp.asarray(boxes.numpy()), jnp.asarray(scores.numpy()), thr,
                    valid=None if valid is None else jnp.asarray(valid.numpy()))
    return torch.from_numpy(np.asarray(keep).copy())


@pytest.mark.parametrize("thr", THRESHOLDS)
@pytest.mark.parametrize("n,seed", [(1, 0), (40, 1), (64, 2), (65, 3), (200, 4)])
def test_bitmask_sweep_equals_the_fixpoint(n, seed, thr):
    boxes, scores, valid = _case(n, seed)
    want = _jax_nms(boxes, scores, thr, valid)
    assert torch.equal(N.nms_bitmask_plain(boxes, scores, thr, valid=valid), want)
    assert torch.equal(N.nms_fixpoint(boxes, scores, thr, valid=valid), want)
    assert torch.equal(N.nms(boxes, scores, thr, valid=valid), want)   # the CPU's route
    want = _jax_nms(boxes, scores, thr)
    assert torch.equal(N.nms_bitmask_plain(boxes, scores, thr), want)
    assert torch.equal(N.nms_fixpoint(boxes, scores, thr), want)


def test_bitmask_sweep_at_ious_on_the_threshold():
    """Pairs whose IoU is the threshold's float32, or one ulp either side:
    both forms compare the float32 IoU with the float32 threshold."""
    boxes = torch.tensor([[0, 0, 10, 10], [0, 0, 10, 7], [0, 0, 10, 10], [0, 3, 10, 10],
                          [0, 0, 10, 10], [0, 0, 7, 10]], dtype=torch.float32)
    scores = torch.tensor([0.9, 0.8, 0.7, 0.6, 0.5, 0.4])
    for thr in (0.7, float(np.nextafter(np.float32(0.7), 0)), float(np.nextafter(0.7, 1)), 0.69):
        want = _jax_nms(boxes, scores, thr)
        assert torch.equal(N.nms_bitmask_plain(boxes, scores, thr), want), thr
        assert torch.equal(N.nms_fixpoint(boxes, scores, thr), want), thr


def test_bitmask_words_and_empty_input():
    """Bit j of word c of row i is the later box 64 c + j overlapping box i;
    no input gives no output."""
    boxes = torch.tensor([[0.0, 0, 10, 10]]).repeat(130, 1)
    words = N.suppression_words(boxes, 0.5)
    assert words.shape == (130, 3)
    for i in (0, 63, 64, 129):
        bits = [(int(words[i, j // 64]) >> (j % 64)) & 1 for j in range(130)]
        assert bits == [int(j > i) for j in range(130)]
    empty = torch.zeros(0, 4)
    assert N.nms_bitmask_plain(empty, torch.zeros(0), 0.7).shape == (0,)
    assert N.nms(empty, torch.zeros(0), 0.7).shape == (0,)
