"""The AMG crop cascade of the port against the JAX package's, on identical
inputs at ``sam_tiny``, float32: the uncrop of boxes and points, the crop
upscale (``upscale_crop_binary``: low -> the SAM input -> the resized
crop's extent -> the crop's own, at a width off the 8-bit packing and a
resized crop shorter than the input), ``amg_select`` with the crop-edge
filter, and ``generate()`` at ``crop_n_layers`` 1 and 2, with and without
small-region cleanup, from one SAM checkpoint read by both importers.

Everything is exact except ``predicted_iou`` and ``stability_score``,
float32 outputs of the network, held to 1e-5 of max(1, |value|)
(``tests/test_torch_amg.py``'s 1e-5, relative where these weights' IoU
head reaches |9|: about ten float32 steps of two libraries' sums there).
The weights (``sam.init`` plus seeded noise) are ones under
which a 48 x 64 image's crops keep masks clear of their inner edges, so
that the cross-crop dedup (1 / crop area as the score, the smaller crop
wins) removes masks and keeps crop masks beside full-frame ones."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as CS
from llmseg_tpu import config as JC
from llmseg_tpu.import_weights import torch_import as JI
from llmseg_tpu.models.sam import amg as jamg
from llmseg_tpu.ops import amg_utils as jau
from llmseg_tpu_torch import config as TC
from llmseg_tpu_torch.models.sam import amg as tamg
from llmseg_tpu_torch.ops import amg_utils as tau

torch.set_num_threads(1)
SCORE_TOL = 1e-5


@pytest.mark.parametrize("crop_box", [(0, 0, 64, 48), (24, 16, 64, 48), (7, 3, 40, 33)])
def test_uncrop_matches_jax(crop_box):
    rng = np.random.RandomState(sum(crop_box))
    boxes = (rng.rand(9, 4) * 40).astype(np.float32)
    points = (rng.rand(5, 2) * 40).astype(np.float32)
    np.testing.assert_array_equal(tau.uncrop_boxes_xyxy(torch.tensor(boxes), crop_box).numpy(),
                                  np.asarray(jau.uncrop_boxes_xyxy(jnp.asarray(boxes), crop_box)))
    np.testing.assert_array_equal(tau.uncrop_points(torch.tensor(points), crop_box).numpy(),
                                  np.asarray(jau.uncrop_points(jnp.asarray(points), crop_box)))


@pytest.mark.parametrize("rhw,chw,bucket", [((64, 43), (37, 25), 8), ((48, 64), (33, 45), None),
                                            ((64, 64), (40, 40), 4)])
def test_upscale_crop_binary_matches_jax(rhw, chw, bucket):
    """(K, 16, 16) bf16 logits -> (s_in 64) -> the valid (rh, rw) -> the
    crop's (ch, cw), thresholded and packed MSB first, the last byte's
    padding zero: the same bytes."""
    rng = np.random.RandomState(rhw[1] + chw[1])
    low = (rng.randn(6, 16, 16) * 3).astype(np.float32)
    low_j = jnp.asarray(low).astype(jnp.bfloat16)
    low_t = torch.tensor(low).bfloat16()
    ref = np.asarray(jamg.upscale_crop_binary(low_j, rhw, chw, 64, 0.0, bucket=bucket))
    got = tamg.upscale_crop_binary(low_t, rhw, chw, 64, 0.0, bucket=bucket).numpy()
    assert got.dtype == np.uint8 and got.shape == ref.shape == (min(bucket or 6, 6), chw[0],
                                                                -(-chw[1] // 8))
    np.testing.assert_array_equal(got, ref)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """One SAM checkpoint read by both importers: the port's model and
    JAX's tree."""
    path = str(tmp_path_factory.mktemp("sam") / "sam.pth")
    model = CS.seeded_sam()
    torch.save(CS.host_copy(CS.ref_sam(model)), path)
    return model, JI.import_sam_pth(path, JC.sam_tiny())


def test_amg_select_crop_edge_filter_matches_jax(weights):
    """A crop's frame (the crop (0, 0, 160, 120) of a 320 x 240 image,
    resized to 64 x 48): candidates within 20 pixels of its right or bottom
    edge are dropped before the NMS, those on the image's edges kept; the
    same survivors."""
    model, params = weights
    amg = dict(points_per_side=4, points_per_batch=8, pred_iou_thresh=-1e9,
               stability_score_thresh=-1.0, max_masks=48)
    emb = np.random.RandomState(0).randn(1, 4, 4, 16).astype(np.float32)
    pts = (tau.build_point_grid(4) * np.array([64, 48])).astype(np.float32)
    kw = dict(crop_box=(0, 0, 160, 120), orig_box=(0, 0, 320, 240),
              box_scale=(160 / 64, 120 / 48))
    rj = jamg.amg_select(params, JC.sam_tiny(), JC.AMGConfig(**amg), jnp.asarray(emb),
                         jnp.asarray(pts), jnp.asarray([48, 64], jnp.int32), 16,
                         **{k: jnp.asarray(v, jnp.float32) for k, v in kw.items()})
    with torch.no_grad():
        rt = tamg.amg_select(model, TC.AMGConfig(**amg), torch.tensor(emb), torch.tensor(pts),
                             (48, 64), **kw)
        plain = tamg.amg_select(model, TC.AMGConfig(**amg), torch.tensor(emb),
                                torch.tensor(pts), (48, 64))
    for k in ("valid", "boxes", "points"):
        np.testing.assert_array_equal(np.asarray(rj[k]), rt[k].numpy(), err_msg=k)
    for k in ("iou", "stability"):
        np.testing.assert_allclose(rt[k].numpy(), np.asarray(rj[k]), atol=SCORE_TOL,
                                   rtol=SCORE_TOL)
    assert 0 < int(rt["valid"].sum()) < int(plain["valid"].sum())


def _generate_matches_jax(model, params, tcfg, jcfg, layers, min_area):
    img = CS.crop_image()
    kw = dict(CS.CROP_AMG, min_mask_region_area=min_area, crop_n_layers=layers)
    aj = jamg.AutomaticMaskGenerator(params, jcfg, JC.AMGConfig(**kw)).generate(img)
    gen = tamg.AutomaticMaskGenerator(model, tcfg, TC.AMGConfig(**kw), device="cpu")
    handle = gen.prefetch(gen.submit(img))
    at = gen.finish(handle)
    assert len(handle["crops"]) == 1 + sum(4 ** i for i in range(1, layers + 1))
    assert len(aj) == len(at)
    for a, b in zip(aj, at):
        assert set(b) == set(a)
        for k in a:
            if k in ("predicted_iou", "stability_score"):
                assert abs(a[k] - b[k]) <= SCORE_TOL * max(1.0, abs(a[k])), k
            else:
                assert a[k] == b[k], k
    staged = sum(n for _, n, _, _, _ in handle["staged"])
    crops = [a["crop_box"] for a in at]
    assert [0, 0, 64, 48] in crops and any(c != [0, 0, 64, 48] for c in crops)
    assert staged > len(at)
    return gen, img, at


@pytest.mark.parametrize("layers,min_area", [(1, 0), (2, 0), (1, 20), (2, 20)])
def test_generate_crop_cascade_matches_jax(weights, layers, min_area):
    """``generate()`` through the crop cascade: every annotation equal to
    JAX's; masks from the crops survive the cross-crop dedup beside
    full-frame ones, and the dedup removed masks."""
    model, params = weights
    gen, img, at = _generate_matches_jax(model, params, TC.sam_tiny(), JC.sam_tiny(), layers,
                                         min_area)
    # generate() is submit, prefetch and finish
    assert gen.generate(img) == at


@pytest.fixture(scope="module")
def crop_weights(tmp_path_factory):
    """``chip_smoke.py``'s amg_crops SAM (``crop_sam``: a 32 x 32 grid, SAM's
    decoder widths; its upscale's taps tied) read by both importers."""
    path = str(tmp_path_factory.mktemp("crop_sam") / "sam.pth")
    model = CS.seeded_sam(CS.crop_sam(TC), **CS.CROP_WEIGHTS)
    torch.save(CS.host_copy(CS.ref_sam(model)), path)
    return model, JI.import_sam_pth(path, CS.crop_sam(JC))


@pytest.mark.parametrize("layers,min_area", [(1, 0), (1, 20)])
def test_generate_crop_cascade_matches_jax_at_crop_sam(crop_weights, layers, min_area):
    """The card's amg_crops configuration on the CPU: a frame's decode
    takes JAX's fused route there (1024 image tokens) and its global block
    kernel E's (T = 1024), so this is the configuration the card holds to
    its CPU run; here the port's plain versions against JAX's, every
    annotation equal, crop masks surviving beside full-frame ones.  One
    crop layer: a second adds 16 frames and no survivor (its crops are
    narrower than the 20-pixel band allows)."""
    model, params = crop_weights
    _generate_matches_jax(model, params, CS.crop_sam(TC), CS.crop_sam(JC), layers, min_area)
