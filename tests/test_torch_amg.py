"""The port's AMG stages against the JAX package's, on identical inputs.

Every stage is compared exactly: grids and crop boxes, stability scores on
bf16 logits, inclusive mask boxes, the crop-edge test, NMS keep sets (with
tied scores, which both sort stably), the bilinear resizes, the RLE codec
and strings, the device-RLE payloads and the annotations built from them.
``generate()`` runs end to end at ``sam_tiny`` with the filters opened, once
without and once with small-region cleanup: every field of every
annotation matches JAX exactly except ``predicted_iou``, a float32 output
of the network, held to 1e-5.  The seeds were chosen so that no bf16 logit
of the candidate masks sits on a threshold, where the two frameworks'
summation orders could flip a pixel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmseg_tpu import config as JC
from llmseg_tpu.models.sam import amg as jamg
from llmseg_tpu.models.sam import sam as jsam
from llmseg_tpu.ops import amg_utils as jau
from llmseg_tpu.ops import device_rle as jdr
from llmseg_tpu.ops import nms as jnms
from llmseg_tpu.ops import rle as jrle
from llmseg_tpu_torch import config as TC
from llmseg_tpu_torch.import_weights.from_jax import load_
from llmseg_tpu_torch.models.sam import amg as tamg
from llmseg_tpu_torch.models.sam import sam as tsam
from llmseg_tpu_torch.ops import amg_utils as tau
from llmseg_tpu_torch.ops import device_rle as tdr
from llmseg_tpu_torch.ops import nms as tnms
from llmseg_tpu_torch.ops import rle as trle

torch.set_num_threads(1)


def _blobs(n, h, w, seed):
    """Blobby binary masks with a few speckles, (n, h, w) bool."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = np.zeros((n, h, w), bool)
    for i in range(n):
        for _ in range(rng.randint(0, 3)):
            cy, cx, r = rng.rand() * h, rng.rand() * w, 2 + rng.rand() * h / 3
            out[i] |= (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
        out[i] ^= rng.rand(h, w) < 0.01
    return out


def test_grids_and_crop_boxes_match_jax():
    np.testing.assert_array_equal(jau.build_point_grid(7), tau.build_point_grid(7))
    for a, b in zip(jau.build_all_layer_point_grids(8, 2, 2), tau.build_all_layer_point_grids(8, 2, 2)):
        np.testing.assert_array_equal(a, b)
    assert jau.generate_crop_boxes((480, 640), 2, 512 / 1500) == \
        tau.generate_crop_boxes((480, 640), 2, 512 / 1500)


def test_stability_boxes_and_crop_edge_match_jax():
    rng = np.random.RandomState(0)
    logits = (rng.randn(6, 32, 32) * 3).astype(np.float32)
    lb_j = jnp.asarray(logits).astype(jnp.bfloat16)
    lb_t = torch.tensor(logits).bfloat16()
    np.testing.assert_array_equal(np.asarray(jau.calculate_stability_score(lb_j, 0.0, 1.0)),
                                  tau.calculate_stability_score(lb_t, 0.0, 1.0).numpy())
    masks = _blobs(6, 20, 30, 1)
    masks[2] = False
    boxes_j = jau.batched_mask_to_box(jnp.asarray(masks))
    boxes_t = tau.batched_mask_to_box(torch.tensor(masks))
    np.testing.assert_array_equal(np.asarray(boxes_j), boxes_t.numpy())
    crop, orig = [10, 5, 40, 30], [0, 0, 64, 48]
    np.testing.assert_array_equal(
        np.asarray(jau.is_box_near_crop_edge(boxes_j, crop, orig)),
        tau.is_box_near_crop_edge(boxes_t, crop, orig).numpy())


@pytest.mark.parametrize("hw_out", [(64, 64), (40, 24), (7, 9)])
def test_resize_bilinear_matches_jax_image_resize(hw_out):
    x = np.random.RandomState(2).randn(3, 16, 16).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x)[..., None], (3, *hw_out, 1), "bilinear")[..., 0]
    np.testing.assert_allclose(np.asarray(ref), tau.resize_bilinear(torch.tensor(x), hw_out).numpy(),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(jau.bilinear_resize_np(x, hw_out), tau.bilinear_resize_np(x, hw_out))


def test_box_iou_and_nms_with_ties_match_jax():
    rng = np.random.RandomState(3)
    xy = rng.rand(40, 2) * 50
    boxes = np.concatenate([xy, xy + 5 + rng.rand(40, 2) * 30], 1).astype(np.float32)
    boxes[7] = boxes[3]                                   # duplicate box
    scores = np.round(rng.rand(40), 1).astype(np.float32)  # many ties
    valid = rng.rand(40) > 0.2
    np.testing.assert_allclose(np.asarray(jnms.box_iou(jnp.asarray(boxes), jnp.asarray(boxes))),
                               tnms.box_iou(torch.tensor(boxes), torch.tensor(boxes)).numpy(),
                               atol=1e-7, rtol=0)
    for thr in (0.3, 0.7):
        kj = jnms.nms(jnp.asarray(boxes), jnp.asarray(scores), thr, valid=jnp.asarray(valid))
        kt = tnms.nms(torch.tensor(boxes), torch.tensor(scores), thr, valid=torch.tensor(valid))
        np.testing.assert_array_equal(np.asarray(kj), kt.numpy())
    idxs = rng.randint(0, 3, 40)
    np.testing.assert_array_equal(
        np.asarray(jnms.batched_nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(idxs), 0.5)),
        tnms.batched_nms(torch.tensor(boxes), torch.tensor(scores), torch.tensor(idxs), 0.5).numpy())
    np.testing.assert_array_equal(jau.nms_host(boxes, scores, 0.5), tau.nms_host(boxes, scores, 0.5))


@pytest.mark.parametrize("mode", ["holes", "islands"])
def test_remove_small_regions_matches_jax(mode):
    for m in _blobs(4, 30, 40, 4):
        a, ca = jau.remove_small_regions(m, 30, mode)
        b, cb = tau.remove_small_regions(m, 30, mode)
        np.testing.assert_array_equal(a, b)
        assert ca == cb


def test_rle_codec_matches_jax():
    for m in _blobs(5, 23, 17, 5):
        r = trle.encode(m.astype(np.uint8))
        assert r == jrle.encode(m.astype(np.uint8))
        np.testing.assert_array_equal(trle.decode(r), m.astype(np.uint8))
        assert trle.area(r) == jrle.area(r) == int(m.sum())
        np.testing.assert_array_equal(trle.to_bbox(r), jrle.to_bbox(r))
        assert trle.string_to_counts(r["counts"]) == jrle.string_to_counts(r["counts"])
        packed = np.packbits(np.pad(m, ((0, 1), (0, 7))), axis=-1)
        assert trle.encode_packed(packed, 23, 17) == jrle.encode_packed(packed, 23, 17)
    rles = [trle.encode(m.astype(np.uint8)) for m in _blobs(3, 10, 12, 6)]
    assert trle.merge(rles) == jrle.merge(rles)


@pytest.mark.parametrize("counts", [
    [], [0], [5], [0, 3], [7, 0, 9], [1, 2, 3, 4],
    [15, 16, 31, 32, 1023, 1024, 0, 2 ** 20, 1, 2 ** 20 - 5, 3, 1048576],
    "random"])
def test_rle_count_strings_match_jax(counts):
    """The counts string codec on raw runs: one- to five-group values and
    deltas of both signs (a run much shorter than the one two before it)."""
    if counts == "random":
        counts = np.random.RandomState(9).randint(0, 5000, 500).tolist()
        counts[100:110] = [0, 2 ** 21, 3, 2 ** 21 - 1, 1, 2, 3, 2 ** 25, 0, 1]
    s = trle.counts_to_string(counts)
    assert s == jrle.counts_to_string(counts)
    assert trle.string_to_counts(s) == [int(c) for c in counts]


@pytest.mark.parametrize("hw,max_per_col", [((48, 60), 8), ((64, 64), 2)])
def test_device_rle_payload_matches_jax(hw, max_per_col):
    """Payload and metadata of upscale_rle, bit for bit, and the annotations
    decoded from them (max_per_col 2 overflows some columns)."""
    rng = np.random.RandomState(7)
    low = (rng.randn(6, 16, 16) * 2).astype(np.float32)
    low[1] = -5.0                                         # an empty mask
    low_bf = jnp.asarray(low).astype(jnp.bfloat16)
    pj, mj = jdr.upscale_rle(low_bf, jnp.asarray(hw, jnp.int32), (64, 64), 0.0, bucket=8,
                             max_per_col=max_per_col)
    pt, mt = tdr.upscale_rle(torch.tensor(low).bfloat16(), hw, (64, 64), 0.0, bucket=8,
                             max_per_col=max_per_col)
    np.testing.assert_array_equal(np.asarray(pj), pt.numpy())
    np.testing.assert_array_equal(np.asarray(mj), mt.numpy())
    aj = jdr.annotations_from_rle_payload(np.asarray(pj), np.asarray(mj), 6, *hw, 64, max_per_col)
    at = tdr.annotations_from_rle_payload(pt.numpy(), mt.numpy(), 6, *hw, 64, max_per_col)
    assert aj == at
    packed_j = jamg.upscale_binary(low_bf, (64, 64), 0.0, bucket=8)
    packed_t = tamg.upscale_binary(torch.tensor(low).bfloat16(), (64, 64), 0.0, bucket=8)
    np.testing.assert_array_equal(np.asarray(packed_j), packed_t.numpy())


def _jitter(params, seed, amp=0.5):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + amp * rng.randn(*np.shape(x))).astype(np.float32), params)


@pytest.mark.parametrize("min_area", [0, 20])
def test_generate_matches_jax(min_area):
    """sam_tiny, 8 x 8 points in chunks of 16, filters opened: the same
    annotations (device RLE route with min_area 0, bit-packed route with
    small-region cleanup and re-NMS otherwise)."""
    p = _jitter(jsam.init(jax.random.PRNGKey(3), JC.sam_tiny()), 4)
    m = load_(tsam.build(TC.sam_tiny(), device="cpu"), p)
    img = np.random.RandomState(3).randint(0, 255, (48, 64, 3), np.uint8)
    kw = dict(points_per_side=8, points_per_batch=16, pred_iou_thresh=-1e9,
              stability_score_thresh=-1.0, box_nms_thresh=0.95, max_masks=64,
              min_mask_region_area=min_area)
    aj = jamg.AutomaticMaskGenerator(p, JC.sam_tiny(), JC.AMGConfig(**kw)).generate(img)
    gen = tamg.AutomaticMaskGenerator(m, TC.sam_tiny(), TC.AMGConfig(**kw), device="cpu")
    at = gen.generate(img)
    assert len(aj) == len(at) >= 3
    for a, b in zip(aj, at):
        assert set(b) == set(a)
        for k in a:
            if k == "predicted_iou":
                assert abs(a[k] - b[k]) <= 1e-5
            else:
                assert a[k] == b[k], k
    # submit / prefetch / finish is the same as generate
    assert gen.finish(gen.prefetch(gen.submit(img))) == at


def test_amg_select_matches_jax_on_identical_embeddings():
    """amg_select from one image embedding: top-K order, boxes, points,
    validity and stability exactly; IoU within 1e-5 and the bf16 logits
    within one bf16 step (2^-7 relative; the float32 logits are rounded)."""
    p = _jitter(jsam.init(jax.random.PRNGKey(0), JC.sam_tiny()), 1)
    m = load_(tsam.build(TC.sam_tiny(), device="cpu"), p)
    amg = dict(points_per_side=4, points_per_batch=8, pred_iou_thresh=0.0,
               stability_score_thresh=0.5, max_masks=16)
    emb = np.random.RandomState(5).randn(1, 4, 4, 16).astype(np.float32)
    pts = (tau.build_point_grid(4) * np.array([64, 48])).astype(np.float32)
    rj = jamg.amg_select(p, JC.sam_tiny(), JC.AMGConfig(**amg), jnp.asarray(emb), jnp.asarray(pts),
                         jnp.asarray([48, 64], jnp.int32), 16)
    rt = tamg.amg_select(m, TC.AMGConfig(**amg), torch.tensor(emb), torch.tensor(pts), (48, 64))
    for k in ("valid", "boxes", "points", "stability"):
        np.testing.assert_array_equal(np.asarray(rj[k]), rt[k].numpy(), err_msg=k)
    np.testing.assert_allclose(np.asarray(rj["iou"]), rt["iou"].numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.asarray(rj["masks_low"].astype(jnp.float32)),
                               rt["masks_low"].float().numpy(), rtol=2 ** -7, atol=0)


def test_generator_guards():
    m = tsam.init(TC.sam_tiny(), device="cpu")
    with pytest.raises(ValueError):
        tamg.AutomaticMaskGenerator(m, device="cpu").generate(np.zeros((80, 40, 3), np.uint8))
    gen = tamg.AutomaticMaskGenerator(m, amg=TC.AMGConfig(crop_n_layers=1), device="cpu")
    with pytest.raises(NotImplementedError):
        gen.submit(np.zeros((48, 64, 3), np.uint8))
