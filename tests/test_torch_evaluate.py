"""The port's validation (``train/evaluate.py``) against
``llmseg_tpu.train.evaluate`` on the same numpy inputs from a seed.

* The compose and counts in torch (:func:`compose_counts`, the path; run
  here on CPU tensors) against the numpy plain path: equal counts, so gIoU
  and cIoU equal to the bit, for every strategy, shapes that need the
  resize to the ground truth, an ignored label, and a padded final batch.
* ``run_validation`` on shared scores (an eval step that echoes them): the
  port's loop, device and plain, against the JAX loop, equal, and equal at
  batch 1, 4 and 8.
* ``run_validation`` end to end at ``llmseg_tiny``: the port's ``eval_step``
  and JAX's ``make_eval_step`` on the same weights (``from_jax``) and
  batches.  Their scores agree within 1e-4 (the whole model in float32 with
  other summation orders, as ``test_torch_llmseg.py``); the IoP head is a
  sigmoid near 0.5 on random weights, so "threshold" at 0.5 selects the
  same proposals only where the JAX score's margin to it exceeds that; the
  metrics are equal where every selection is, and a differing selection
  must sit within twice the scores' tolerance of a knife edge (an IoP at
  the threshold, or two similarities the ranking tells apart); its margin
  is reported.
"""

import jax
import numpy as np
import pytest
import torch

from llmseg_tpu import config as JC
from llmseg_tpu.data.synthetic import make_batch as jmake_batch
from llmseg_tpu.models import llmseg as jllmseg
from llmseg_tpu.train import evaluate as jeval
from llmseg_tpu.train import train_step as jtrain_step
from llmseg_tpu_torch import config as TC
from llmseg_tpu_torch.data.synthetic import make_batch as tmake_batch
from llmseg_tpu_torch.import_weights.from_jax import load_
from llmseg_tpu_torch.models import llmseg as tllmseg
from llmseg_tpu_torch.train import evaluate as teval
from llmseg_tpu_torch.train.train_step import eval_step

torch.set_num_threads(1)
STRATEGIES = ("threshold", "argmax", "iou_iop", "top_iou")
SCORE_TOL = 1e-4


def _samples(n=10, K=6, seed=0):
    """Per image: scores, proposals at one size and a ground truth at
    another (or the same), as ``tests/test_train.py``'s batched test."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        h, w = rng.randint(30, 60), rng.randint(30, 60)
        gh, gw = (h, w) if i % 3 == 0 else (rng.randint(20, 70), rng.randint(20, 70))
        out.append({
            "sim": rng.rand(K).astype(np.float32),
            "iou": rng.rand(K).astype(np.float32),
            "valid": rng.rand(K) < 0.8,
            "segs": (rng.rand(h, w, K) < 0.4).astype(np.uint8),
            "gt": (rng.rand(gh, gw) < 0.4).astype(np.float32),
        })
    return out


def _batches_of(samples, bsz, as_torch):
    """(batch of scores, extras) pairs; a short final batch is padded with
    copies of its last row, marked False in ``row_valid``."""
    for j in range(0, len(samples), bsz):
        chunk = samples[j:j + bsz]
        n_valid = len(chunk)
        chunk = chunk + [chunk[-1]] * (bsz - n_valid)
        batch = {k: np.stack([s[k] for s in chunk]) for k in ("sim", "iou", "valid")}
        if as_torch:
            batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        extras = {"segs_origin": [s["segs"] for s in chunk],
                  "masks_list": [[s["gt"]] for s in chunk],
                  "image_paths": [None] * bsz, "conversations": [[""]] * bsz,
                  "row_valid": [True] * n_valid + [False] * (bsz - n_valid)}
        yield batch, extras


def _echo(model, batch):
    return {"pred_similarity": batch["sim"], "pred_iou": batch["iou"],
            "prop_valid": batch["valid"]}


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_compose_counts_equal_the_numpy_path(strategy):
    for s in _samples(seed=1):
        keep = teval.select(strategy, s["sim"], s["iou"], s["valid"], 0.5)
        pred = teval.compose_mask(s["segs"], keep)
        if pred.shape != s["gt"].shape:
            pred = teval._nearest_resize_2d(pred, s["gt"].shape)
        ref_acc, got_acc = teval.SegEvalAccumulator(), teval.SegEvalAccumulator()
        ref_acc.add(pred, s["gt"])
        counts = teval.compose_counts(torch.from_numpy(s["segs"]),
                                      torch.as_tensor(np.asarray(keep, np.int64)),
                                      torch.from_numpy(s["gt"]))
        assert counts.dtype == torch.int64 and counts.shape == (2, 2)
        got_acc.add_counts(counts[0].numpy(), counts[1].numpy())
        np.testing.assert_array_equal(got_acc.intersection.sum, ref_acc.intersection.sum)
        np.testing.assert_array_equal(got_acc.union.sum, ref_acc.union.sum)
        assert got_acc.result() == ref_acc.result()


def test_compose_counts_keep_ignored_and_empty_cases():
    rng = np.random.RandomState(5)
    segs = (rng.rand(37, 29, 4) < 0.5).astype(np.uint8) * 3      # nonzero, not 1
    gt = (rng.rand(50, 41) < 0.5).astype(np.float32)
    gt[rng.rand(50, 41) < 0.1] = 255.0                             # ignored pixels
    for keep in ([], [2], [0, 3], [0, 1, 2, 3]):
        pred = jeval.compose_mask(segs, np.array(keep, np.int64))
        pred = jeval._nearest_resize_2d(pred, gt.shape)
        ref = jeval.SegEvalAccumulator()
        ref.add(pred, gt)
        got = teval.SegEvalAccumulator()
        c = teval.compose_counts(torch.from_numpy(segs), torch.tensor(keep, dtype=torch.int64),
                                 torch.from_numpy(gt))
        got.add_counts(c[0].numpy(), c[1].numpy())
        np.testing.assert_array_equal(got.intersection.sum, ref.intersection.sum)
        np.testing.assert_array_equal(got.union.sum, ref.union.sum)
        assert got.result() == ref.result()


def test_numpy_helpers_equal_jax():
    s = _samples(n=3, seed=2)
    for x in s:
        for strategy in STRATEGIES:
            kw = {} if strategy == "argmax" else {"threshold": 0.5}
            got = teval.select(strategy, x["sim"], x["iou"], x["valid"], 0.5)
            ref = jeval.SELECTORS[strategy](x["sim"], x["iou"], x["valid"], **kw)
            np.testing.assert_array_equal(got, ref)
            np.testing.assert_array_equal(teval.compose_mask(x["segs"], got),
                                          jeval.compose_mask(x["segs"], ref))
        for hw in (x["gt"].shape, (1024, 1024), (5, 80)):
            np.testing.assert_array_equal(teval._nearest_resize_2d(x["gt"], hw),
                                          jeval._nearest_resize_2d(x["gt"], hw))
            np.testing.assert_array_equal(
                teval.nearest_resize_2d(torch.from_numpy(x["gt"]), hw).numpy(),
                jeval._nearest_resize_2d(x["gt"], hw))


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_run_validation_on_shared_scores_equals_jax_at_every_batch_size(strategy):
    """tests/test_train.py's batch 1 = 4 = 8 test, for the JAX loop, the
    port's loop and the port's plain loop, all equal."""
    samples = _samples()
    results = {}
    for bsz in (1, 4, 8):
        results[("jax", bsz)] = jeval.run_validation(
            lambda p, b: _echo(None, b), None, _batches_of(samples, bsz, False),
            strategy=strategy)
        results[("port", bsz)] = teval.run_validation(
            _echo, None, _batches_of(samples, bsz, True), strategy=strategy)
        results[("plain", bsz)] = teval.run_validation(
            _echo, None, _batches_of(samples, bsz, True), strategy=strategy, plain=True)
    ref = results[("jax", 1)]
    assert set(ref) == {"giou", "ciou"}
    for key, r in results.items():
        assert r == ref, (strategy, key, r, ref)


def test_run_validation_skips_padded_rows_and_bf16_scores():
    """A padded row that would change the metric is skipped; bf16 scores
    (the card's bf16 model) select as their float32 values do."""
    samples = _samples(n=5, seed=3)
    ref = teval.run_validation(_echo, None, _batches_of(samples, 5, True))
    padded = list(_batches_of(samples, 8, True))
    batch, extras = padded[0]
    extras["masks_list"][-1] = [1.0 - extras["masks_list"][-1][0]]
    assert teval.run_validation(_echo, None, padded) == ref
    bf16 = [({k: v.to(torch.bfloat16) if v.is_floating_point() else v
              for k, v in b.items()}, e) for b, e in _batches_of(samples, 5, True)]
    rounded = [({k: v.float() if v.is_floating_point() else v for k, v in b.items()}, e)
               for b, e in bf16]
    assert teval.run_validation(_echo, None, bf16) == teval.run_validation(_echo, None, rounded)


def _params():
    p = jllmseg.init(jax.random.PRNGKey(0), JC.llmseg_tiny())
    rng = np.random.RandomState(1)
    return jax.tree.map(
        lambda x: (np.asarray(x) + 0.05 * rng.randn(*np.shape(x))).astype(np.float32), p)


def test_run_validation_end_to_end_matches_jax():
    params = _params()
    model = load_(tllmseg.build(TC.llmseg_tiny(), device="cpu"), params)
    K = TC.llmseg_tiny().max_proposals
    rng = np.random.RandomState(0)
    n_batches, bsz = 2, 2
    extras = []
    for _ in range(n_batches):
        extras.append({"segs_origin": [(rng.rand(40, 50, K) < 0.4).astype(np.uint8)
                                       for _ in range(bsz)],
                       "masks_list": [[(rng.rand(36, 48) < 0.4).astype(np.float32)]
                                      for _ in range(bsz)],
                       "image_paths": [None] * bsz, "conversations": [[""]] * bsz})
    kw = dict(num_images=bsz, rows_per_image=1, text_len=32)
    jbs = [jmake_batch(JC.llmseg_tiny(), seed=i, **kw) for i in range(n_batches)]
    tbs = [tmake_batch(TC.llmseg_tiny(), device="cpu", seed=i, **kw) for i in range(n_batches)]

    jstep = jax.jit(jtrain_step.make_eval_step(JC.llmseg_tiny()))
    jouts = [jstep(params, b) for b in jbs]
    touts = [eval_step(model, b) for b in tbs]
    for j, t in zip(jouts, touts):
        for k in ("pred_similarity", "pred_iou"):
            np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), atol=SCORE_TOL, rtol=0)
        np.testing.assert_array_equal(t["prop_valid"].numpy(), np.asarray(j["prop_valid"]))

    for strategy in STRATEGIES:
        same, margins = True, []
        for j, t in zip(jouts, touts):
            for r in range(bsz):
                args = [np.asarray(o[k][r], np.float32) if k != "prop_valid" else
                        np.asarray(o[k][r]) for o in (j,)
                        for k in ("pred_similarity", "pred_iou", "prop_valid")]
                targs = [t[k][r].numpy() for k in ("pred_similarity", "pred_iou", "prop_valid")]
                sel_j = teval.select(strategy, *args, 0.5)
                sel_t = teval.select(strategy, *targs, 0.5)
                if not np.array_equal(sel_j, sel_t):
                    # the knife edges: an IoP score at the threshold, or two
                    # similarities that the ranking tells apart
                    sims = np.sort(args[0][args[2]])
                    margin = min(float(np.abs(args[1][args[2]] - 0.5).min()),
                                 float(np.diff(sims).min()) if sims.size > 1 else np.inf)
                    same = False
                    margins.append(margin)
                    assert margin <= 2 * SCORE_TOL, (strategy, margin)
        jres = jeval.run_validation(jstep, params, zip(jbs, extras), strategy=strategy)
        tres = teval.run_validation(eval_step, model, zip(tbs, extras), strategy=strategy)
        print(strategy, "JAX", jres, "port", tres, "equal selections", same)
        if same:
            assert tres == jres, strategy
        else:
            print(f"{strategy}: selections differ at JAX IoP margins {margins}")
        assert np.isfinite(tres["giou"]) and np.isfinite(tres["ciou"])
