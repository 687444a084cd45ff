"""Every dataset class of ``llmseg_tpu_torch.data.datasets`` against its JAX
counterpart on corpora written from a seed in the reference's on-disk
layouts (as ``tests/test_datasets.py`` writes them, about 60 x 80 images):
ReasonSeg (with its explanatory file), ReferSeg (refcoco, refclef and
grefcoco), SemSeg through each ``init_*`` (ade20k, cocostuff, mapillary,
paco_lvis, pascal_part), VQA, LLM-Seg40K, the Hybrid mixture, and the two
validation sets.  The same seed must give the same sample dicts, drawn in
the same order: every field equal to the bit (dtype, shape, values), except
``segs``, the proposals resized by ``data.resample.cv2_resize``, which is
held to cv2 within 1e-6 absolute (the resampler's tolerance: it sums in
float64 where cv2 sums in float32).  The JAX labels run on its numpy path
(the native library switched off), which the port's ``compute_all_iou_iop``
copies; the native one's float32 division may differ in the last place."""

import json
import pickle

import cv2
import numpy as np
import pytest

from llmseg_tpu.data import datasets as JD
from llmseg_tpu.data.mask_reader import SamMaskReader as JReader
from llmseg_tpu.native import loader as jnative
from llmseg_tpu.ops import rle as jrle
from llmseg_tpu_torch.data import datasets as TD
from llmseg_tpu_torch.data.mask_reader import SamMaskReader as TReader

from test_torch_data import CV2_TOL, assert_tree_equal

SIZES = dict(image_size=56, clip_size=28, seg_grid=16)
DRAWS = 6


@pytest.fixture(autouse=True)
def numpy_labels(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)


def write_jpg(path, rng, h=60, w=80):
    path.parent.mkdir(parents=True, exist_ok=True)
    cv2.imwrite(str(path), rng.randint(0, 256, (h, w, 3)).astype(np.uint8))


def write_masks(path, names, rng, h=60, w=80, k=5):
    doc = []
    for name in names:
        masks = []
        for _ in range(k):
            m = np.zeros((h, w), np.uint8)
            y, x = rng.randint(0, h - 12), rng.randint(0, w - 12)
            hh, ww = rng.randint(3, 12, 2)
            m[y:y + hh, x:x + ww] = 1
            masks.append({"segmentation": jrle.encode(m), "area": int(m.sum()),
                          "bbox": [float(x), float(y), float(ww), float(hh)]})
        doc.append({"image": name, "target_size": [h, w], "masks": masks})
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(doc))


def readers(paths):
    """The same masks.json files read by both packages' readers."""
    return ({k: JReader(str(p), verbose=False) for k, p in paths.items()},
            {k: TReader(str(p), verbose=False) for k, p in paths.items()})


def assert_samples_equal(got, ref):
    assert set(got) == set(ref)
    np.testing.assert_allclose(got["segs"], ref["segs"], rtol=0, atol=CV2_TOL)
    assert got["segs"].dtype == ref["segs"].dtype
    assert_tree_equal({k: v for k, v in got.items() if k != "segs"},
                      {k: v for k, v in ref.items() if k != "segs"})


def draw_both(jds, tds, n=DRAWS, indices=None):
    indices = list(range(n)) if indices is None else indices
    assert len(tds) == len(jds)
    for i in indices:
        assert_samples_equal(tds[i], jds[i])


# ---------------------------------------------------------------------------
# ReasonSeg
# ---------------------------------------------------------------------------


@pytest.fixture
def reason_tree(tmp_path):
    rng = np.random.RandomState(0)
    root = tmp_path / "dataset"
    for split in ("train", "val"):
        d = root / "reason_seg" / "ReasonSeg" / split
        names = []
        for i in range(3):
            write_jpg(d / f"img{i}.jpg", rng)
            anno = {"shapes": [{"label": "target",
                                "points": [[5, 5], [30 + i, 5], [30, 30 + i], [5, 30]]},
                               {"label": "ignore", "points": [[40, 40], [50, 40], [50, 50]]}],
                    "text": [f"the thing {i}", "another phrase", "a third one"],
                    "is_sentence": bool(i % 2)}
            (d / f"img{i}.json").write_text(json.dumps(anno))
            names.append(f"img{i}.jpg")
        write_masks(root / f"masks_{split}.json", names, rng)
    expl = root / "reason_seg" / "ReasonSeg" / "explanatory"
    expl.mkdir()
    (expl / "train.json").write_text(json.dumps(
        [{"image": "img0.jpg", "query": "why?", "outputs": "because"}]))
    return root


def test_reason_seg_matches_jax(reason_tree):
    jr, tr = readers({s: reason_tree / f"masks_{s}.json" for s in ("train", "val")})
    kw = dict(samples_per_epoch=8, seed=3, num_classes_per_sample=2, **SIZES)
    jds = JD.ReasonSegDataset(str(reason_tree), jr, **kw)
    tds = TD.ReasonSegDataset(str(reason_tree), tr, **kw)
    assert tds.images == jds.images and tds.img_to_explanation == jds.img_to_explanation
    draw_both(jds, tds)


def test_val_reason_seg_matches_jax(reason_tree):
    jr, tr = readers({"val": reason_tree / "masks_val.json"})
    jds = JD.ValReasonSegDataset(str(reason_tree), jr["val"], **SIZES)
    tds = TD.ValReasonSegDataset(str(reason_tree), tr["val"], **SIZES)
    draw_both(jds, tds, indices=range(len(jds)))
    assert tds[0]["inference"] and tds[0]["segs_origin"] is not None


# ---------------------------------------------------------------------------
# referring segmentation
# ---------------------------------------------------------------------------


def _instances(names, rng, h=60, w=80):
    anns = []
    for i, _ in enumerate(names):
        m = np.zeros((h, w), np.uint8)
        m[10:30, 20 + i:50] = 1
        anns += [{"id": 100 + 2 * i, "image_id": i + 1, "category_id": 5,
                  "bbox": [4, 4, 20, 20],
                  "segmentation": [[4, 4, 24, 4, 24, 24 + i, 4, 24]]},
                 {"id": 101 + 2 * i, "image_id": i + 1, "category_id": 6,
                  "bbox": [20, 10, 30, 20], "segmentation": jrle.encode(m)}]
    return {"images": [{"id": i + 1, "height": h, "width": w, "file_name": n}
                       for i, n in enumerate(names)],
            "annotations": anns,
            "categories": [{"id": 5, "name": "bench"}, {"id": 6, "name": "dog"}]}


@pytest.fixture
def refer_tree(tmp_path):
    rng = np.random.RandomState(1)
    data = tmp_path / "refer_seg"
    coco_names = [f"COCO_train2014_{i:012d}.jpg" for i in range(1, 4)]
    clef_names = ["00/1.jpg", "00/2.jpg"]
    for n in coco_names:
        write_jpg(data / "images" / "mscoco" / "images" / "train2014" / n, rng)
    for n in clef_names:
        write_jpg(data / "images" / "saiapr_tc-12" / n, rng)
    for ds, names in (("refcoco", coco_names), ("refclef", clef_names),
                      ("grefcoco", coco_names)):
        d = data / ds
        d.mkdir(parents=True)
        (d / "instances.json").write_text(json.dumps(_instances(names, rng)))
        refs = []
        for i in range(2 * len(names)):
            img = i // 2 + 1
            ann = 100 + 2 * (img - 1) + i % 2
            if ds == "grefcoco":
                ann = [100 + 2 * (img - 1), 101 + 2 * (img - 1)] if i % 2 else [-1]
            refs.append({"ref_id": i, "ann_id": ann, "image_id": img, "category_id": 5 + i % 2,
                         "split": "train" if i != 1 else "val",
                         "sentences": [{"sent_id": 3 * i + j, "sent": f" The Thing {i}.{j} ",
                                        "tokens": ["the", "thing"]} for j in range(2)]})
        with open(d / ("grefs(unc).p" if ds == "grefcoco" else "refs(unc).p"), "wb") as f:
            pickle.dump(refs, f)
    write_masks(tmp_path / "coco14.json", coco_names, rng)
    write_masks(tmp_path / "saiapr.json",
                [f"saiapr_tc-12/{n}" for n in clef_names], rng)
    return tmp_path


@pytest.mark.parametrize("data", ["refcoco", "refclef", "grefcoco",
                                  "refclef||refcoco||grefcoco"])
def test_refer_seg_matches_jax(refer_tree, data):
    jr, tr = readers({"c": refer_tree / "coco14.json", "s": refer_tree / "saiapr.json"})
    kw = dict(refer_seg_data=data, seed=5, num_classes_per_sample=3, **SIZES)
    jds = JD.ReferSegDataset(str(refer_tree), jr["c"], jr["s"], **kw)
    tds = TD.ReferSegDataset(str(refer_tree), tr["c"], tr["s"], **kw)
    for ds in jds.data:
        assert tds.data[ds]["images"] == jds.data[ds]["images"]
        assert tds.data[ds]["img2refs"] == jds.data[ds]["img2refs"]
    draw_both(jds, tds)


# ---------------------------------------------------------------------------
# semantic segmentation: each init_*
# ---------------------------------------------------------------------------


def _label(rng, h=60, w=80, ids=(0, 1, 2, 3)):
    lab = np.full((h, w), ids[0], np.uint8)
    lab[: h // 2] = ids[1]
    lab[h // 2:, : w // 2] = ids[2]
    lab[rng.randint(0, h), :] = ids[3]
    return lab


@pytest.fixture(scope="module")
def sem_tree(tmp_path_factory):
    """One root with the five corpora.  (Its name must not contain
    "cocostuff": init_cocostuff maps label paths to image paths by replacing
    that word.)"""
    root = tmp_path_factory.mktemp("semseg")
    rng = np.random.RandomState(2)
    # ade20k: raw label 0 = ignore
    (root / "ade20k").mkdir()
    (root / "ade20k" / "ade20k_classes.json").write_text(json.dumps(["wall", "building", "sky"]))
    ade = []
    for i in range(2):
        write_jpg(root / "ade20k" / "images" / "training" / f"a{i}.jpg", rng)
        p = root / "ade20k" / "annotations" / "training" / f"a{i}.png"
        p.parent.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(p), _label(rng, ids=(0, 1, 3, 2)))
        ade.append(f"a{i}.jpg")
    # cocostuff: classes with "-" are ignored
    (root / "cocostuff" / "train2017").mkdir(parents=True)
    (root / "cocostuff" / "cocostuff_classes.txt").write_text(
        "0: unlabeled\n0: person\n1: bicycle\n2: wall-brick\n3: sky-other\n4: grass\n")
    coco17 = []
    for i in range(2):
        write_jpg(root / "coco" / "train2017" / f"c{i}.jpg", rng)
        cv2.imwrite(str(root / "cocostuff" / "train2017" / f"c{i}.png"),
                    _label(rng, ids=(255, 0, 2, 4)))
        coco17.append(f"c{i}.jpg")
    # mapillary
    (root / "mapillary").mkdir()
    (root / "mapillary" / "config_v2.0.json").write_text(json.dumps(
        {"labels": [{"readable": "Road"}, {"readable": "Car"}, {"readable": "Sky"},
                    {"readable": "Pole"}]}))
    mapi = []
    for i in range(2):
        write_jpg(root / "mapillary" / "training" / "images" / f"m{i}.jpg", rng)
        p = root / "mapillary" / "training" / "v2.0" / "labels" / f"m{i}.png"
        p.parent.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(p), _label(rng, ids=(0, 1, 2, 3)))
        mapi.append(f"m{i}.jpg")
    # paco_lvis (images under coco/) and pascal_part
    paco = _instances([f"train2017/p{i}.jpg" for i in range(2)], rng)
    paco["categories"] = [{"id": 5, "name": "mug_(cup):handle"}, {"id": 6, "name": "dog"}]
    for i in range(2):
        write_jpg(root / "coco" / "train2017" / f"p{i}.jpg", rng)
    d = root / "vlpart" / "paco" / "annotations"
    d.mkdir(parents=True)
    (d / "paco_lvis_v1_train.json").write_text(json.dumps(paco))
    voc = _instances([f"v{i}.jpg" for i in range(2)], rng)
    voc["categories"] = [{"id": 5, "name": "person:hand"}, {"id": 6, "name": "cat:ear"}]
    for i in range(2):
        write_jpg(root / "vlpart" / "pascal_part" / "VOCdevkit" / "VOC2010" / "JPEGImages"
                  / f"v{i}.jpg", rng)
    (root / "vlpart" / "pascal_part" / "train.json").write_text(json.dumps(voc))
    write_masks(root / "m_ade.json", ade, rng)
    write_masks(root / "m_coco17.json", coco17 + ["p0.jpg", "p1.jpg"], rng)
    write_masks(root / "m_mapi.json", mapi, rng)
    write_masks(root / "m_voc.json", ["v0.jpg", "v1.jpg"], rng)
    return root


SEM_READERS = {"ade20k": "m_ade.json", "coco2017": "m_coco17.json",
               "mapillary": "m_mapi.json", "voc2010": "m_voc.json"}


@pytest.mark.parametrize("init", sorted(JD.SEM_SEG_INITS))
def test_sem_seg_init_matches_jax(sem_tree, init):
    assert set(TD.SEM_SEG_INITS) == set(JD.SEM_SEG_INITS)
    got, ref = TD.SEM_SEG_INITS[init](str(sem_tree)), JD.SEM_SEG_INITS[init](str(sem_tree))
    if init in ("paco_lvis", "pascal_part"):
        assert got[0] == ref[0] and got[1] == ref[1]
        assert got[2].dataset == ref[2].dataset
    else:
        assert_tree_equal(got, ref)


@pytest.mark.parametrize("data", ["ade20k", "cocostuff", "mapillary", "paco_lvis",
                                  "pascal_part",
                                  "ade20k||cocostuff||pascal_part||paco_lvis||mapillary"])
def test_sem_seg_matches_jax(sem_tree, data):
    jr, tr = readers({k: sem_tree / v for k, v in SEM_READERS.items()})
    kw = dict(sem_seg_data=data, seed=11, num_classes_per_sample=2, **SIZES)
    jds = JD.SemSegDataset(str(sem_tree), jr, **kw)
    tds = TD.SemSegDataset(str(sem_tree), tr, **kw)
    draw_both(jds, tds)


# ---------------------------------------------------------------------------
# VQA, LLM-Seg40K, Hybrid, ValLLMSeg
# ---------------------------------------------------------------------------


def test_vqa_matches_jax(tmp_path):
    rng = np.random.RandomState(4)
    names = ["v0.jpg", "v1.jpg"]
    for n in names:
        write_jpg(tmp_path / "coco" / "train2017" / n, rng)
    doc = [{"image": names[0], "conversations": [
               {"from": "human", "value": "<image>\nWhat is shown?"},
               {"from": "gpt", "value": "A random pattern."},
               {"from": "human", "value": "Why?"}, {"from": "gpt", "value": "Noise."}]},
           {"image": names[1], "conversations": [
               {"from": "gpt", "value": "dropped lead"},
               {"from": "human", "value": "<image>\nColours?"},
               {"from": "gpt", "value": "Many."}]}]
    (tmp_path / "llava_dataset").mkdir()
    (tmp_path / "llava_dataset" / "llava_instruct_150k.json").write_text(json.dumps(doc))
    write_masks(tmp_path / "vqa.json", names, rng)
    jr, tr = readers({"r": tmp_path / "vqa.json"})
    jds = JD.VQADataset(str(tmp_path), jr["r"], seed=2, **SIZES)
    tds = TD.VQADataset(str(tmp_path), tr["r"], seed=2, **SIZES)
    draw_both(jds, tds)


def write_llmseg(root, rng, n_images=3, qa=2, h=60, w=80, k=5):
    """LLM-Seg40K's layout: {image: {from_dataset, qa_pairs: [{question,
    answer, rle_seg}]}}, images under coco/train2017 and
    ego_objects/images, one masks.json per source."""
    doc, names = {}, {"coco": [], "ego_objects": []}
    for i in range(n_images):
        src = "coco" if i % 2 == 0 else "ego_objects"
        name = f"{src}_{i}.jpg"
        sub = "coco/train2017" if src == "coco" else "ego_objects/images"
        write_jpg(root / sub / name, rng, h, w)
        pairs = []
        for j in range(qa):
            gt = np.zeros((h, w), np.uint8)
            gt[5 + j:h // 2, 3:w // 2 + i] = 1
            pairs.append({"question": f"What would hold item {i}.{j}?",
                          "answer": "The box [SEG].", "rle_seg": jrle.encode(gt)})
        doc[name] = {"from_dataset": src, "qa_pairs": pairs}
        names[src].append(name)
    (root / "train.json").write_text(json.dumps(doc))
    for src, ns in names.items():
        write_masks(root / f"{src}_masks.json", ns, rng, h, w, k=k)
    return root


def _llmseg_readers(root):
    return readers({"coco": root / "coco_masks.json", "ego": root / "ego_objects_masks.json"})


def test_llmseg_and_val_match_jax(tmp_path):
    root = write_llmseg(tmp_path, np.random.RandomState(5))
    jr, tr = _llmseg_readers(root)
    args = (str(root / "train.json"), str(root / "coco" / "train2017"),
            str(root / "ego_objects" / "images"))
    jds = JD.LLMSegDataset(*args, jr["coco"], jr["ego"], seed=9, **SIZES)
    tds = TD.LLMSegDataset(*args, tr["coco"], tr["ego"], seed=9, **SIZES)
    assert tds.samples == jds.samples
    draw_both(jds, tds, indices=range(len(jds) + 2))
    jv = JD.ValLLMSegDataset(*args, jr["coco"], jr["ego"], limit=4, seed=1, **SIZES)
    tv = TD.ValLLMSegDataset(*args, tr["coco"], tr["ego"], limit=4, seed=1, **SIZES)
    np.testing.assert_array_equal(tv.order, jv.order)
    draw_both(jv, tv, indices=range(len(jv)))


def test_hybrid_matches_jax(reason_tree, tmp_path):
    root = write_llmseg(tmp_path / "llm", np.random.RandomState(6))
    jr, tr = readers({s: reason_tree / f"masks_{s}.json" for s in ("train", "val")})
    jl, tl = _llmseg_readers(root)
    args = (str(root / "train.json"), str(root / "coco" / "train2017"),
            str(root / "ego_objects" / "images"))
    kw = dict(samples_per_epoch=10, num_classes_per_sample=2, **SIZES)
    parts = []
    for D, r, l in ((JD, jr, jl), (TD, tr, tl)):
        reason = D.ReasonSegDataset(str(reason_tree), r, seed=1, **kw)
        llm = D.LLMSegDataset(*args, l["coco"], l["ego"], seed=2, **SIZES)
        parts.append(D.HybridDataset([reason, llm], [3, 1], samples_per_epoch=10, seed=4))
    jh, th = parts
    np.testing.assert_array_equal(th.probs, jh.probs)
    draw_both(jh, th, n=8)


def test_imread_stays_on_cv2(tmp_path):
    """The decode is cv2's, imported when called; a missing file raises."""
    write_jpg(tmp_path / "x.jpg", np.random.RandomState(0))
    np.testing.assert_array_equal(TD._imread_rgb(str(tmp_path / "x.jpg")),
                                  JD._imread_rgb(str(tmp_path / "x.jpg")))
    with pytest.raises(FileNotFoundError):
        TD._imread_rgb(str(tmp_path / "missing.jpg"))
