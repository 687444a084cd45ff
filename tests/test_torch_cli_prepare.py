"""The port's ``prepare`` and ``convert_h5`` against the JAX CLI's, on the
CPU at ``sam_tiny`` (``MODEL_REGISTRY["vit_h"]`` patched on both sides),
from one ``--sam_ckpt`` written from seeded weights, on jpg files written
from a seed (two within the SAM input, one twice as large that both shrink
with cv2's INTER_AREA), with the filters opened as ``tests/test_cli.py``
opens them, at ``--crop_n_layers`` 0 and 1.

Both CLIs load the checkpoint in bf16; the test runs each generator's model
in float32 (its bf16 weights upcast, on both sides): a bf16 SAM forward of
the two libraries rounds differently (82 % of a ``sam_tiny`` embedding's
values differ), so only float32 forwards can give the same masks.  The
masks.json documents are equal: RLE counts, bbox, area, crop_box and
point_coords exactly, predicted_iou and stability_score within 1e-5 of
max(1, |value|) (the IoU head of these weights reaches |9|, where 1e-5 is
about ten float32 steps of two libraries' sums).  ``--hdf5`` then each
package's ``convert`` gives the same records, and the port's ``convert``
of JAX's file gives JAX's records exactly."""

import json

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as CS
from cli import convert_h5 as jconvert
from cli import prepare as jprepare
from llmseg_tpu import config as JC
from llmseg_tpu.import_weights import torch_import as JI
from llmseg_tpu.models.sam import amg as jamg
from llmseg_tpu.models.sam import sam as jsam
from llmseg_tpu_torch import config as TC
from llmseg_tpu_torch.cli import convert_h5 as tconvert
from llmseg_tpu_torch.cli import prepare as tprepare
from llmseg_tpu_torch.data.mask_reader import SamMaskReader
from llmseg_tpu_torch.import_weights import torch_import as TI
from llmseg_tpu_torch.models.sam import amg as tamg
from llmseg_tpu_torch.models.sam import sam as tsam

torch.set_num_threads(1)
SCORE_TOL = 1e-5
OPEN = ["--points_per_side", "8", "--points_per_batch", "16", "--pred_iou_thresh=-1e9",
        "--stability_score_thresh=-1"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("prepare")
    torch.save(CS.host_copy(CS.ref_sam(CS.seeded_sam())), str(root / "sam.pth"))
    rng = np.random.RandomState(1)
    (root / "imgs").mkdir()
    for name, hw in (("a.jpg", (48, 64)), ("b.jpg", (64, 40)), ("c.jpg", (96, 128))):
        cv2.imwrite(str(root / "imgs" / name), rng.randint(0, 255, (*hw, 3), np.uint8))
    return root


@pytest.fixture
def float32_generators(monkeypatch):
    """Both registries at sam_tiny; each generator runs its model in
    float32."""
    monkeypatch.setitem(jsam.MODEL_REGISTRY, "vit_h", JC.sam_tiny)
    monkeypatch.setitem(tsam.MODEL_REGISTRY, "vit_h", TC.sam_tiny)

    class JGen(jamg.AutomaticMaskGenerator):
        def __init__(self, params, cfg, amg=None):
            super().__init__(jax.tree.map(lambda x: x.astype(jnp.float32), params), cfg, amg)

    class TGen(tamg.AutomaticMaskGenerator):
        def __init__(self, model, cfg=None, amg=None, *, device="cuda"):
            assert next(model.parameters()).dtype == torch.bfloat16
            super().__init__(model.float(), cfg, amg, device=device)

    monkeypatch.setattr(jamg, "AutomaticMaskGenerator", JGen)
    monkeypatch.setattr(tamg, "AutomaticMaskGenerator", TGen)


def assert_docs_equal(got, ref):
    assert [(d["image"], d["target_size"]) for d in got] == \
        [(d["image"], d["target_size"]) for d in ref]
    for g, r in zip(got, ref):
        assert len(g["masks"]) == len(r["masks"])
        for a, b in zip(g["masks"], r["masks"]):
            assert set(a) == set(b)
            for k in b:
                if k in ("predicted_iou", "stability_score"):
                    assert abs(a[k] - b[k]) <= SCORE_TOL * max(1.0, abs(b[k])), (k, a[k], b[k])
                else:
                    assert a[k] == b[k], k


@pytest.mark.parametrize("layers", [0, 1])
def test_prepare_matches_jax(layers, corpus, float32_generators, tmp_path):
    argv = ["--image_dir", str(corpus / "imgs"), "--sam_ckpt", str(corpus / "sam.pth"),
            "--crop_n_layers", str(layers)] + OPEN
    docs, h5s = {}, {}
    for side, main, extra in (("jax", jprepare.main, []),
                              ("port", tprepare.main, ["--device", "cpu"])):
        out, h5s[side] = tmp_path / f"{side}.json", str(tmp_path / f"{side}.h5")
        main(argv + ["--output", str(out), "--hdf5", h5s[side]] + extra)
        docs[side] = json.loads(out.read_text())
    assert_docs_equal(docs["port"], docs["jax"])
    assert [d["target_size"] for d in docs["port"]] == [[48, 64], [64, 40], [48, 64]]
    assert all(d["masks"] for d in docs["port"])
    crops = [a["crop_box"] for d in docs["port"] for a in d["masks"]]
    if layers:      # masks from the crops survived the dedup beside full-frame ones
        assert any(c[2:] != [64, 48] for c in crops) and [0, 0, 64, 48] in crops
    # --hdf5, then each package's convert: the same records
    records = {}
    for side, convert in (("jax", jconvert.convert), ("port", tconvert.convert)):
        out = tmp_path / f"{side}_from_h5.json"
        assert convert(h5s[side], str(out)) == 3
        records[side] = json.loads(out.read_text())
    assert_docs_equal(*(sorted(records[s], key=lambda r: r["image"]) for s in ("port", "jax")))
    out = tmp_path / "cross.json"
    tconvert.convert(h5s["jax"], str(out))
    assert json.loads(out.read_text()) == records["jax"]
    # read back by the training side's reader
    reader = SamMaskReader(str(tmp_path / "port.json"), verbose=False)
    assert reader.extract_sam_segs("a.jpg")["segs_origin"].shape[:2] == (48, 64)


def test_prepare_shards_and_limit_match_jax(corpus, float32_generators, tmp_path):
    """Round-robin shards (the reference's split_coco) and --limit pick the
    same files."""
    argv = ["--image_dir", str(corpus / "imgs"), "--sam_ckpt", str(corpus / "sam.pth"),
            "--num_shards", "2", "--shard", "0", "--limit", "1"] + OPEN
    jprepare.main(argv + ["--output", str(tmp_path / "j.json")])
    tprepare.main(argv + ["--output", str(tmp_path / "t.json"), "--device", "cpu"])
    got, ref = (json.loads((tmp_path / n).read_text()) for n in ("t.json", "j.json"))
    assert [d["image"] for d in got] == ["a.jpg"]
    assert_docs_equal(got, ref)


def _bf16_ulps(a, b):
    """|a - b| in units of the bf16 spacing at the larger magnitude."""
    m = np.maximum(np.abs(a), np.abs(b)).astype(np.float64)
    return np.abs(a.astype(np.float64) - b) / 2.0 ** (np.floor(np.log2(np.maximum(m, 1e-30))) - 7)


BF16_EMB_MEDIAN_ULPS = 4      # measured 2.0 on each image
BF16_EMB_MAX_REL = 0.03       # max |port - JAX| of max |JAX|; measured 0.0115-0.0136
BF16_OWN_ROUNDING = 1.5       # the port's median ulps from float32 over JAX's; measured 1.07-1.10
BF16_COUNT_GAP = 8            # annotations an image; measured 0, 0, 1 and 6, 0, 1
BF16_MASK_IOU_MEDIAN = 0.7    # masks matched by box, both ways; measured 0.872 and 0.913


@pytest.mark.parametrize("layers", [0, 1])
def test_prepare_in_bf16_against_jax(layers, corpus, monkeypatch, tmp_path):
    """Both CLIs as users run them, in bf16 (the checkpoint loaded in bf16
    and the generators on it), over the seeded corpus.  The two libraries'
    bf16 SAM forwards round differently, so the documents are held by
    measures, bounded with a margin over what was measured (sam_tiny, these
    weights and images):
      * the image embedding (each generator's own encode of each image):
        median gap 2.0 bf16 ulps on every image, max 133.5-222 ulps (at
        values near zero), the largest |port - JAX| 1.15-1.36 % of max
        |JAX|; each library's median distance from a float32 forward of
        the same weights 1.40-1.58 ulps (port) and 1.29-1.48 (JAX): the
        port rounds as JAX does, to a tenth of an ulp;
      * the masks.json masks: annotations an image 2/2, 2/2, 5/4 (port /
        JAX) at crop layers 0, 8/14, 2/2, 5/4 at 1; the IoU of each mask
        with its match by box, both ways, median 0.872 and 0.913, the
        smallest 0.006 (a 5-pixel mask).
    """
    monkeypatch.setitem(jsam.MODEL_REGISTRY, "vit_h", JC.sam_tiny)
    monkeypatch.setitem(tsam.MODEL_REGISTRY, "vit_h", TC.sam_tiny)
    ckpt = str(corpus / "sam.pth")
    argv = ["--image_dir", str(corpus / "imgs"), "--sam_ckpt", ckpt,
            "--crop_n_layers", str(layers)] + OPEN
    docs = {}
    for side, main, extra in (("jax", jprepare.main, []),
                              ("port", tprepare.main, ["--device", "cpu"])):
        out = tmp_path / f"{side}.json"
        main(argv + ["--output", str(out)] + extra)
        docs[side] = json.loads(out.read_text())
    assert [d["image"] for d in docs["port"]] == [d["image"] for d in docs["jax"]]
    ious = []
    for got, ref in zip(docs["port"], docs["jax"]):
        assert got["masks"] and abs(len(got["masks"]) - len(ref["masks"])) <= BF16_COUNT_GAP
        ious += CS.match_by_box(got["masks"], ref["masks"]) + CS.match_by_box(ref["masks"],
                                                                             got["masks"])
    assert np.median(ious) >= BF16_MASK_IOU_MEDIAN, ious

    # each generator's encode of each image: its bf16 model, the image as
    # prepare reads it
    cfg_j, cfg_t = JC.sam_tiny(), TC.sam_tiny()
    params = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), JI.import_sam_pth(ckpt, cfg_j))
    port = TI.load_sam_into(tsam.build(cfg_t, device="cpu", dtype=torch.bfloat16), ckpt,
                            device="cpu")
    f32 = TI.load_sam_into(tsam.build(cfg_t, device="cpu", dtype=torch.bfloat16), ckpt,
                           device="cpu").float()
    s = cfg_t.encoder.img_size
    for name in sorted(d["image"] for d in docs["port"]):
        img = tprepare.preprocess_image(tprepare._imread_rgb(str(corpus / "imgs" / name)), s)
        h, w = img.shape[:2]
        padded = np.zeros((s, s, 3), np.uint8)
        padded[:h, :w] = img
        region = np.zeros((1, s, s, 1), np.float32)
        region[:, :h, :w] = 1.0
        ej = np.asarray(jamg._prep_encode(params, cfg_j, jnp.asarray(padded)[None],
                                          jnp.asarray(region)).astype(jnp.float32))
        x = tsam.preprocess(torch.from_numpy(padded)[None], cfg_t) * torch.tensor(region)
        with torch.no_grad():
            et = tsam.encode_image(port, x).float().numpy()
            e32 = tsam.encode_image(f32, x).numpy()
        assert np.median(_bf16_ulps(et, ej)) <= BF16_EMB_MEDIAN_ULPS, name
        assert np.abs(et - ej).max() <= BF16_EMB_MAX_REL * np.abs(ej).max(), name
        assert np.median(_bf16_ulps(et, e32)) <= BF16_OWN_ROUNDING * np.median(
            _bf16_ulps(ej, e32)), name


def test_prepare_in_bf16_writes_the_reference_schema(corpus, monkeypatch, tmp_path):
    """The port's CLI as a user runs it, bf16 with the crop cascade, no
    checkpoint (random weights and a warning): one document an image in the
    reference's schema, crop boxes inside the image."""
    monkeypatch.setitem(tsam.MODEL_REGISTRY, "vit_h", TC.sam_tiny)
    out = tmp_path / "masks.json"
    tprepare.main(["--image_dir", str(corpus / "imgs"), "--output", str(out), "--device", "cpu",
                   "--crop_n_layers", "1"] + OPEN)
    doc = json.loads(out.read_text())
    assert [d["image"] for d in doc] == ["a.jpg", "b.jpg", "c.jpg"]
    keys = {"segmentation", "area", "bbox", "predicted_iou", "point_coords",
            "stability_score", "crop_box"}
    for d in doc:
        h, w = d["target_size"]
        for a in d["masks"]:
            assert set(a) == keys
            x, y, cw, ch = a["crop_box"]
            assert 0 <= x and 0 <= y and x + cw <= w and y + ch <= h
            assert a["segmentation"]["size"] == [h, w] and a["area"] > 0


def test_prepare_asks_for_the_card_by_default(corpus, monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setitem(tsam.MODEL_REGISTRY, "vit_h", TC.sam_tiny)
    with pytest.raises(RuntimeError, match="CUDA"):
        tprepare.main(["--image_dir", str(corpus / "imgs"), "--output",
                       str(tmp_path / "m.json")] + OPEN)


def test_smoke_cli_phase_runs_small_on_the_cpu(capsys, monkeypatch):
    """``chip_smoke.py``'s cli phase as the card runs it (finetune,
    validate in bf16 and W8A8, prepare at crop layers 0 and 1), but at
    ``llmseg_tiny`` and ``sam_tiny`` on the CPU with small images: its
    gates hold (no launches here) and it prints a line a sub-run and one for
    the phase.  The learning rate is 1e-3 here: an update of the default
    1e-5 vanishes in bf16 on most of a tiny LoRA A's values (the card's
    7B ones have many small enough to move)."""
    from llmseg_tpu_torch.ops import attention as A
    from llmseg_tpu_torch.ops import quant as Q
    from llmseg_tpu_torch.ops import relpos_attention as R
    from llmseg_tpu_torch.ops import twoway_kernel as TK

    monkeypatch.setitem(tsam.MODEL_REGISTRY, "vit_h", TC.sam_tiny)
    rng = np.random.RandomState(2)
    images = [rng.randint(0, 255, hw + (3,), np.uint8) for hw in ((48, 64), (64, 40), (64, 64))]
    records = CS.cli_phase(TC, A.KERNELS + R.KERNELS + TK.KERNELS + Q.KERNELS, device="cpu",
                           model_size="tiny",
                           extra_argv=["--image_size", "56", "--model_max_length", "480",
                                       "--lr", "1e-3"],
                           shapes=((60, 80), (80, 60), (53, 80)), proposals=6,
                           prep_images=images, points_per_side=8)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('{"phase": "cli"')]
    assert [r["run"] for r in lines] == ["finetune", "validate", "validate_w8a8",
                                         "prepare_crop_layers_0", "prepare_crop_layers_1", "all"]
    assert all(r["ok"] for r in lines) and all("seconds" in r for r in lines)
    assert records[0]["val_images"] == 13 and records[1]["val_batches"] == 2
    assert records[0]["lora_moved"] == records[0]["lora_tensors"] > 0
    assert records[2]["resumed_lora_equals_saved"] and records[2]["bf16"]["giou"] >= 0
    assert records[4]["frames"] == 5 and all(records[4]["annotations"])
